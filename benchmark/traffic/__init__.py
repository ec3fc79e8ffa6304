"""Traffic drivers: one general generator per kind of traffic, driven by
the parameters in a cell's file under `workloads/`."""
