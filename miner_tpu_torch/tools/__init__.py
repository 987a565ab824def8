"""Command-line tools of the port: checkpoints to and from the reference,
and the end-to-end tools (the planted corpus, MIND preparation, the
turnkey run, at-scale convergence, the quality protocol's port leg)."""
