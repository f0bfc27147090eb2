"""Launchers of the port: the LM server (``serve``) and the training loop
(``train``).  The production mesh and the dry-run wait for their slice
(ROADMAP Queue A item (e))."""
