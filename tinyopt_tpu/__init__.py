"""tinyopt_tpu — a JAX nonlinear optimization framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference C++ library (julien-michot/tinyopt, mounted at /root/reference):
non-linear least squares with Gauss-Newton and Levenberg-Marquardt, general
unconstrained optimization with gradient descent, forward-mode AD of
residuals on manifold tangent spaces, numerical differentiation, robust
norms / M-estimators, Lie-group (SO3/SE3) parameters, covariance recovery —
plus the accelerator capabilities the reference lacks: batched instances via
``vmap``, a batched CG kernel for the GPU, and mesh-sharded scale-out with
``psum``-reduced normal equations.
"""

from .cost import Cost
from .options import (
    Options, SolverType, HessianOptions, CostScalingOptions, LMOptions,
    GDOptions, SGDOptions, AdamOptions, LBFGSOptions, LogOptions,
    LevenbergMarquardt, GaussNewton, GradientDescent, SGD, Adam, AdamW,
    LBFGS, DogLeg,
)
from .output import Output
from .stop_reasons import StopReason, stop_reason_description
from .optimize import (optimize, Optimize, build_solver,
                       covariance_at, multi_start_optimize)
from .manifold import (
    Manifold, register_manifold, tangent_spec, retract, local, TangentSpec,
)
from . import diff
from . import losses
from . import manifolds
from . import models
from . import parallel
from . import sparse
from . import utils
from . import implicit
from . import checkpoint
from .parallel import (batched_optimize, batched_solver,
                       sharded_optimize, sharded_schur_optimize,
                       sharded_schur_sparse_covariance)
from .checkpoint import stepper, Stepper
from .profiling import profile_iterations, dispatch_floor
from .implicit import implicit_solver
from .sparse import (block_optimize, matfree_optimize, schur_optimize,
                     schur_sparse_covariance,
                     schur_sparse_covariance_buckets,
                     schur_sparse_optimize,
                     schur_sparse_optimize_buckets, sparse_optimize)
from .chain import ChainSystem, chain_marginals, chain_optimize
from .ops.block import BlockDiag
from .version import __version__

# Namespace products mirroring the reference (optimizers/{nlls,unconstrained}.h)
from . import _methods as _m
lm = _m.lm
gn = _m.gn
gd = _m.gd
sgd = _m.sgd
adam = _m.adam
adamw = _m.adamw
lbfgs = _m.lbfgs
dogleg = _m.dogleg
nlls = _m.lm
unconstrained = _m.gd

__all__ = [
    "optimize", "Optimize", "build_solver", "covariance_at",
    "multi_start_optimize",
    "Options", "SolverType", "Output", "Cost", "StopReason",
    "stop_reason_description",
    "HessianOptions", "CostScalingOptions", "LMOptions", "GDOptions",
    "SGDOptions", "AdamOptions", "LBFGSOptions", "LogOptions",
    "LevenbergMarquardt", "GaussNewton", "GradientDescent",
    "SGD", "Adam", "AdamW", "LBFGS", "DogLeg",
    "Manifold", "register_manifold", "tangent_spec", "retract", "local",
    "TangentSpec",
    "lm", "gn", "gd", "sgd", "adam", "adamw", "lbfgs", "dogleg",
    "nlls",
    "unconstrained",
    "diff", "losses", "manifolds", "models", "parallel", "sparse", "utils",
    "checkpoint",
    "batched_optimize", "batched_solver", "sharded_optimize",
    "sharded_schur_optimize",
    "stepper", "Stepper",
    "profile_iterations", "dispatch_floor",
    "block_optimize", "matfree_optimize", "sparse_optimize",
    "schur_optimize", "schur_sparse_optimize",
    "schur_sparse_optimize_buckets",
    "schur_sparse_covariance", "schur_sparse_covariance_buckets",
    "sharded_schur_sparse_covariance",
    "BlockDiag",
    "chain_optimize", "chain_marginals", "ChainSystem",
    "implicit", "implicit_solver",
    "__version__",
]
