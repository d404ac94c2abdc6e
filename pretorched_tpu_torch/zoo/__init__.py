"""Weight conversion and loading."""
