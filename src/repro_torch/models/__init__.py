"""The LM substrate: configuration, blocks (attention, MoE, Mamba-1) and
the LM assembly with its prefill / decode entry points."""
