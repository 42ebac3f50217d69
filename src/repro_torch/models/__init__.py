"""Models of the ported paths: the paper's CTR network (``ctr``)."""
