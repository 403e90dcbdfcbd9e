"""Launch tooling: input specs (``specs``), the H100's roofline
(``roofline``), a dry-run that counts a step's work on fake tensors, one
card's or one tensor-parallel rank's (``dryrun``), and meshes of ranks
(``mesh``)."""
