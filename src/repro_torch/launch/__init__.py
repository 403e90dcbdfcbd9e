"""Launch tooling for one H100: input specs (``specs``), the H100's
roofline (``roofline``) and a dry-run that counts a step's work on fake
tensors (``dryrun``)."""
