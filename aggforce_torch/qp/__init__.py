"""Force-map optimizers: uniform aggregation, the linear QP, the featurized fit,
the Gaussian noised maps."""
# ruff: noqa: F401
from .qplinear import (
    qp_linear_map,
    qp_form,
    make_bond_constraint_matrix,
    SolverOptions,
    DEFAULT_SOLVER_OPTIONS,
)
from .basicagg import constraint_aware_uni_map
from .featlinearmap import (
    FeatZipper,
    Multifeaturize,
    GeneralizedFeatures,
    GeneralizedFeaturizer,
    qp_feat_linear_map,
    id_feat,
    multifeaturize,
)
from .feat import gb_feat
from .fusedfeat import (
    GBFeatSpec,
    FusedGBMap,
    fused_gb_linear_map,
    fused_gb_linear_map_batch,
    fused_gb_linear_map_blocked,
)
from .cv import fused_gb_cv, fused_gb_cv_grid, linear_map_cv
from .gauss import (
    joptgauss_map,
    stagedjoptgauss_map,
    stagedjslicegauss_map,
    stagedjforcegauss_map,
)
