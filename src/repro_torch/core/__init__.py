"""The host hierarchy (keys, hash index, MEM-PS, SSD-PS, nodes), copied
from the reference, plus the device-side serving residency (``hbm_ps``)."""
