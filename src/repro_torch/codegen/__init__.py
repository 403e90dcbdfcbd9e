"""Template-based DCIM generator: structural Verilog netlists, gate-census
audit vs the cost model, and a deterministic floorplanner (P&R stand-in).

Host text generation, byte for byte the reference's: no device work and
no device argument (the one cost-model call, ``audit.model_area``, runs
on the CPU)."""
from .generator import design_from_point, generate  # noqa: F401
from .verilog import DcimDesign, generate_netlists  # noqa: F401
