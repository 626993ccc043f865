"""mcmcglm_tpu_torch: the PyTorch + CUDA port of ``mcmcglm_tpu``.

The port runs the free-running CGGibbs sampler (``FreeRunCGGibbs``) with
all six slice kernels and the exact conjugate coordinate draws on a CUDA
GPU, a block of passes per CUDA graph replay, its speculative proposal
batteries in hand-written CUDA kernels (``csrc/freerun_battery.cu``), and
the fused engine (``FusedCGGibbs``, ``engine="fused"``) whose coordinate
updates are hand-written CUDA kernels too (``csrc/fused_cggibbs.cu``).
The lockstep engine (``CGGibbs``: ``engine="xla"``, the "naive" linear
predictor, the normal-normal oracle, any registered slice kernel) runs in
plain PyTorch, as the JAX package's runs in plain XLA, and drives the
update-against-naive comparison (``perf.py``) and the batched tuning
sweep (``sweep.py``).  Both kernel sets serve all 21 built-in
family/link pairs.  The result's ``predict``, ``waic``, ``loo`` and
``trace_plot`` and the native host ESS are ported too.  Several cards run
one process each over ``torch.distributed`` with a (chain, obs)
``DeviceMesh`` (``parallel``: the chain-sharded and obs-sharded
free-running engines and the sharded lockstep engine, ``mcmcglm(mesh=)``),
and ``CheckpointManager`` saves and restores any engine's state bitwise.
The cross-validation baselines (``baselines``: NUTS, HMC, ADVI and the
whole-vector elliptical, hyperrectangle, latent and quantile slice
samplers) run on the same log posterior, and ``utils.profiling`` traces
and times a block.  It imports torch and never JAX; the JAX package stays the reference that
the port's tests hold it against.
"""

__version__ = "0.1.0"

from .api import mcmcglm
from .checkpoint import CHECKPOINT_FORMAT, CheckpointManager
from .convert import (
    convert_advi_result,
    convert_ess_state,
    convert_fused_state,
    convert_lockstep_state,
    convert_mv_slice_state,
    convert_sharded_state,
    convert_state,
)
from .datagen import generate_glm_data, generate_normal_data
from .diagnostics import ess, split_rhat, summarize
from .engine import CGGibbs, ChainState, EngineConfig
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
    MultivariateNormal,
    MVNPrior,
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
    log_density,
    log_likelihood,
    log_potential_from_betaj,
    make_beta_prior,
    negative_binomial,
    poisson,
    register_family,
    register_link,
    update_linear_predictor,
)
from .ops import (
    SLICE_KERNELS,
    SliceKernel,
    SliceRNG,
    get_slice_kernel,
    register_slice_kernel,
    slice_doubling,
    slice_elliptical,
    slice_genelliptical,
    slice_latent,
    slice_quantile,
    slice_stepping_out,
    slice_stepping_out_batched,
)
from .parallel import make_mesh
from .parallel.freerun_obs_sharded import ObsShardedFreeRunCGGibbs
from .parallel.freerun_sharded import ShardedFreeRunCGGibbs
from .parallel.sharded_engine import ShardedCGGibbs
from .perf import (
    compare_eta_comptime,
    compare_eta_comptime_across_nvars,
    plot_eta_comptime,
)
from .results import MCMCGLM
from .sweep import mcmcglm_across_tuningparams, plot_mcmcglm_across_tuningparams
