"""LM architecture -> DCIM macro provisioning (workloads + mapper)."""
from .mapper import MacroPlan, plan  # noqa: F401
from .workloads import ArchWorkload, GemmWorkload, extract  # noqa: F401
