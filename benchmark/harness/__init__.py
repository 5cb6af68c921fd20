"""The harness: the run (``core``), what it reads by name (``spec``), the
port's side (``program``), the comparison that
decides ``correct`` (``gate``), the trace's reduction (``trace``) and the
card's published peaks (``peaks``)."""
