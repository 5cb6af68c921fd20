"""Runnable tutorials of the port (twins of the repo's ``tutorials/``)."""
