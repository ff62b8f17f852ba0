"""Multi-device solve: the device mesh and the collectives over it."""
