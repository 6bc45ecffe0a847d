"""Host utilities of the port: rotating logs and the artifact figures."""
