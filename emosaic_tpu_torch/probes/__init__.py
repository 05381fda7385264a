"""Lab probes of the port: each measures one kernel or one memory question on a GPU."""
