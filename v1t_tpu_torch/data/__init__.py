"""Host-side data descriptions for the port."""
