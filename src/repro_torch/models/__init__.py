"""Model configuration (the model code itself is not ported yet)."""
