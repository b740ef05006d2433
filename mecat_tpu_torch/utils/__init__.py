"""Host utilities: logging, metrics, the read simulator."""
