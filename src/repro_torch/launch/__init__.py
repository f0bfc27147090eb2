"""Launchers of the port: the LM server (``serve``).  The production mesh,
the dry-run and the training loop wait for their slices (ROADMAP Queue
A)."""
