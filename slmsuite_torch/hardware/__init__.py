"""Hardware of the port: the SLM interface and its simulated SLM."""
