"""SEGA-DCIM core: cost models, design space, NSGA-II explorer."""
from . import cells, components, explorer, macros, modules, nsga2, pareto, precision, results, scenario, space  # noqa: F401
from .cells import CALIBRATED, CellLibrary, TechParams, TSMC28  # noqa: F401
from .explorer import ParetoPoint, brute_force_front, distill, explore, explore_multi, run_islands, run_islands_multi  # noqa: F401
from .macros import MacroCosts, fp_macro, int_macro, macro_costs, physical  # noqa: F401
from .nsga2 import NSGA2Config, NSGA2Result  # noqa: F401
from .precision import Precision  # noqa: F401
from .results import ResultStore  # noqa: F401
from .scenario import ScenarioTable  # noqa: F401
from .space import DesignSpace  # noqa: F401
