from .families import (
    Family,
    binomial,
    check_family,
    gamma,
    gaussian,
    inverse_gaussian,
    negative_binomial,
    poisson,
    register_family,
)
from .links import Link, get_link, register_link
from .priors import BetaPrior, Distribution, IIDPrior, Normal, make_beta_prior
