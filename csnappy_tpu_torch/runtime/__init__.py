"""Host runtime of the port."""
