"""Weight conversion and loading; training checkpoints."""
