"""DCIM functional simulation: bit-exact macro execution + accounting."""
from .functional import DCIMMacroSim, dcim_numerics, quantize_sym  # noqa: F401
