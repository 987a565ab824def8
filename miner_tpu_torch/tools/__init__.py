"""Command-line tools of the port: checkpoints to and from the reference,
the end-to-end tools (the planted corpus, MIND preparation, the turnkey run,
at-scale convergence, the quality protocol's port leg) and the analysis
tools (warm start against cold, UniSRec's pretrain-to-finetune contract and
its learnability diagnostic, the shared-init trajectory pair)."""
