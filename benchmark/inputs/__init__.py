"""Input kinds, one file each (``inputs/<kind>.py``), named by a traffic
file's ``inputs``."""
