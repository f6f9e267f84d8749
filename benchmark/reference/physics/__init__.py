"""The device step's physics and the host life cycle."""
