"""Force-map optimizers: the featurized fit and its featurizers."""
# ruff: noqa: F401
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
    fused_gb_linear_map_blocked,
)
