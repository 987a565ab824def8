"""Command-line tools of the port: checkpoints to and from the reference."""
