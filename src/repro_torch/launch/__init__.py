"""Launchers of the port: the LM server (``serve``), the training loop
(``train``) and the meshes they run on (``mesh``: the abstract production
meshes and the host mesh over ``torch.distributed``'s ranks).  The
dry-run waits for its slice (ROADMAP Queue A item (e))."""
