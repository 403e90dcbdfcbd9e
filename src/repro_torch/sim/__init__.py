"""DCIM functional simulation: bit-exact macro execution + accounting."""
from .functional import DCIMMacroSim, quantize_sym  # noqa: F401
