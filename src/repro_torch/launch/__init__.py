"""Launchers of the port: the LM server (``serve``), the training loop
(``train``), the meshes they run on (``mesh``: the abstract production
meshes and the host mesh over ``torch.distributed``'s ranks) and the
dry-run that prices a rank's program on the production meshes
(``dryrun``)."""
