"""The cross-validation baselines on the shared log posterior.

Counterpart of ``mcmcglm_tpu/baselines``: HMC, NUTS and mean-field ADVI
(``make_log_posterior`` and its gradient through ``torch.autograd``), and
the whole-vector elliptical, hyperrectangle, latent and quantile slice
samplers.  Plain PyTorch, C chains at once, on the card by default (no
kernel of their own: the JAX package's baselines reach no Pallas kernel).
"""

from .advi import ADVIResult, advi_fit
from .ess_mv import EllipticalSliceGLM
from .hmc import HMCResult, hmc_sample
from .logdensity import make_log_posterior
from .mv_slice import HyperrectSliceGLM, LatentSliceGLM, QuantileSliceGLM
from .nuts import NUTSResult, nuts_sample

__all__ = [
    "ADVIResult",
    "EllipticalSliceGLM",
    "HMCResult",
    "HyperrectSliceGLM",
    "LatentSliceGLM",
    "NUTSResult",
    "QuantileSliceGLM",
    "advi_fit",
    "hmc_sample",
    "make_log_posterior",
    "nuts_sample",
]
