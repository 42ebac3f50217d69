"""The host hierarchy (keys, hash index, MEM-PS, SSD-PS, nodes, the
conflict-aware ``hier_ps`` engine, ``PSClient``, the pipeline and fault
injection), copied from the reference, plus device residency (``hbm_ps``)."""
