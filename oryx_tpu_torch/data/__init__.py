"""Host-side data utilities."""
