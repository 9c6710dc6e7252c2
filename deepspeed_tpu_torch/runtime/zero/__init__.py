"""ZeRO at world size 1: the offloaded optimizer (``offload.py``).  The
partitioned layouts of ZeRO-1/2/3 wait for multi-GPU (ROADMAP.md)."""
