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
from .potential import (
    log_density,
    log_likelihood,
    log_potential_from_betaj,
    make_coord_target,
    update_linear_predictor,
)
from .priors import (
    BetaPrior,
    Distribution,
    Exponential,
    Gamma,
    IIDPrior,
    Laplace,
    MultivariateNormal,
    MVNPrior,
    Normal,
    StackedPrior,
    StudentT,
    Uniform,
    make_beta_prior,
)
