"""mcmcglm_tpu_torch: the PyTorch + CUDA port of ``mcmcglm_tpu``.

The port runs the free-running CGGibbs sampler (``FreeRunCGGibbs``) with
all six slice kernels and the exact conjugate coordinate draws on a CUDA
GPU, a block of passes per CUDA graph replay, its speculative proposal
batteries in hand-written CUDA kernels (``csrc/freerun_battery.cu``), and
the fused engine (``FusedCGGibbs``, ``engine="fused"``) whose coordinate
updates are hand-written CUDA kernels too (``csrc/fused_cggibbs.cu``).  It imports torch and never JAX; the JAX
package stays the reference that the port's tests hold it against.  What
is not ported yet raises NotImplementedError naming its ROADMAP item.
"""

__version__ = "0.1.0"

from .api import mcmcglm
from .convert import convert_fused_state, convert_state
from .datagen import generate_glm_data, generate_normal_data
from .diagnostics import ess, split_rhat, summarize
from .formula import Design, build_design, design_from_arrays
from .freerun import FreeRunCGGibbs, FreeRunState, QuantileState
from .fused import FusedCGGibbs, FusedState
from .models import (
    BetaPrior,
    Distribution,
    Exponential,
    Family,
    Gamma,
    IIDPrior,
    Laplace,
    Link,
    Normal,
    StackedPrior,
    StudentT,
    Uniform,
    binomial,
    check_family,
    gamma,
    gaussian,
    get_link,
    inverse_gaussian,
    make_beta_prior,
    negative_binomial,
    poisson,
    register_family,
    register_link,
)
from .results import MCMCGLM
