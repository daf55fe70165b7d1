"""Command-line tools of the port (counterparts of the root tools/)."""
