"""TMap serialization: save/load fitted maps as npz archives.

Counterpart of the JAX package's ``utils/serialize.py``, in the same
format: one .npz file holding the arrays under generated keys and a JSON
structure tree (``__tree__``) whose nodes carry the same ``"type"`` tags.
The port writes its ``TLinearMap`` under the JAX tag ``"JLinearMap"`` and
its ``TCondNormal`` under ``"JCondNormal"``, and reads those tags back as
its own classes, so a map saved by either package loads in the other.

Covered: LinearMap / TLinearMap, SeperableTMap, CLAFTMap with a FusedGBMap
force map, AugmentedTMap (TCondNormal / SimpleCondNormal augmenters with
linear-map premaps), ComposedTMap, NullForcesTMap, RATMap. Generic CLAMaps
built from arbitrary python closures are rejected with a clear error.

Augmenter noise: a JAX augmenter's state is a PRNG key (``"rkey"``, two
uint32 words), a ``TCondNormal``'s a seed and its torch generators. The
port writes its seed as the key's two words (so the JAX package reads a
valid key) and its generators' states under ``"torch_generators"`` (which
the JAX package ignores); it reads a key as the seed those words spell.
The two packages' draws therefore differ; a map's matrices and variance do
not.
"""

import json
from typing import Any, Dict

import numpy as np
import torch

from ..map import (
    AugmentedTMap,
    CLAFTMap,
    ComposedTMap,
    LinearMap,
    NullForcesTMap,
    RATMap,
    SeperableTMap,
    TLinearMap,
)
from ..qp.fusedfeat import FusedGBMap, GBFeatSpec
from ..trajectory import SimpleCondNormal, TCondNormal
from ..trajectory.gaussian import _ident
from .device import DeviceLike, resolve_device

__all__ = ["load_tmap", "save_tmap"]


class _Archive:
    """Accumulates arrays under auto-generated keys."""

    def __init__(self) -> None:
        self.arrays: Dict[str, np.ndarray] = {}
        self._n = 0

    def add(self, arr) -> str:
        key = f"arr_{self._n}"
        self._n += 1
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        self.arrays[key] = np.asarray(arr)
        return key


def _encode_linear(lm: LinearMap, ar: _Archive) -> Dict[str, Any]:
    out = {
        "type": "JLinearMap" if isinstance(lm, TLinearMap) else "LinearMap",
        "matrix": ar.add(lm.standard_matrix),
        "handle_nans": lm.handle_nans,
        "nan_check_threshold": lm.nan_check_threshold,
    }
    if isinstance(lm, TLinearMap):
        out["bypass_nan_check"] = lm.bypass_nan_check
    return out


def _decode_linear(node: Dict[str, Any], data, device: torch.device) -> LinearMap:
    mat = data[node["matrix"]]
    if node["type"] == "JLinearMap":
        return TLinearMap(
            mat,
            bypass_nan_check=node["bypass_nan_check"],
            handle_nans=node["handle_nans"],
            nan_check_threshold=node["nan_check_threshold"],
            device=device,
        )
    return LinearMap(
        mat,
        handle_nans=node["handle_nans"],
        nan_check_threshold=node["nan_check_threshold"],
    )


def _seed_words(seed: int) -> np.ndarray:
    """A seed as the two uint32 words of a JAX PRNG key."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], dtype=np.uint32)


def _encode_augmenter(aug, ar: _Archive) -> Dict[str, Any]:
    if isinstance(aug, SimpleCondNormal):
        return {
            "type": "SimpleCondNormal",
            "var": float(aug.var),
            "dtype": np.dtype(aug.dtype).name,
        }
    if isinstance(aug, TCondNormal):
        node: Dict[str, Any] = {
            "type": "JCondNormal",
            "dtype": np.dtype(aug.dtype).name,
            "rkey": ar.add(_seed_words(aug.seed)),
            "torch_generators": {
                str(dev): ar.add(gen.get_state()) for dev, gen in aug._gens.items()
            },
        }
        if np.ndim(aug._cov) != 2:
            node["cov_scalar"] = float(aug._cov)
        else:
            node["cov_matrix"] = ar.add(aug._cov)
        for field, name in ((aug.premap, "premap"), (aug.source_postmap, "postmap")):
            if field is _ident:
                node[name] = None
            elif isinstance(field, LinearMap):
                node[name] = _encode_linear(field, ar)
            elif (
                getattr(field, "__self__", None) is not None
                and isinstance(field.__self__, LinearMap)
                and field.__name__ == "flat_call"
            ):
                node[name] = dict(_encode_linear(field.__self__, ar), flat_call=True)
            else:
                raise ValueError(
                    f"Cannot serialize augmenter {name}: arbitrary callables "
                    "are not supported (use LinearMap-based maps)."
                )
        return node
    raise ValueError(f"Cannot serialize augmenter of type {type(aug)!r}.")


def _decode_augmenter(node: Dict[str, Any], data, device: torch.device):
    if node["type"] == "SimpleCondNormal":
        return SimpleCondNormal(var=node["var"], dtype=np.dtype(node["dtype"]))
    cov = node["cov_scalar"] if "cov_scalar" in node else data[node["cov_matrix"]]

    def decode_map_field(sub):
        if sub is None:
            return None
        lm = _decode_linear(sub, data, device)
        return lm.flat_call if sub.get("flat_call") else lm

    hi, lo = (int(w) for w in data[node["rkey"]])
    aug = TCondNormal(
        cov=cov,
        premap=decode_map_field(node["premap"]),
        source_postmap=decode_map_field(node["postmap"]),
        seed=(hi << 32) | lo,
        dtype=np.dtype(node["dtype"]),
        device=device,
    )
    for dev_name, key in node.get("torch_generators", {}).items():
        dev = torch.device(dev_name)
        if dev.type == "cuda" and not torch.cuda.is_available():
            continue  # a fresh generator from the seed serves this device
        gen = torch.Generator(device=dev)
        gen.set_state(torch.as_tensor(data[key]))
        aug._gens[dev] = gen
    return aug


def _encode_fused_gb(fm: FusedGBMap, ar: _Archive) -> Dict[str, Any]:
    spec = fm._spec
    return {
        "type": "FusedGBMap",
        "coefs": ar.add(fm._coefs),
        "cmap_mat": ar.add(fm._cmap_mat),
        "onehot": ar.add(fm._onehot),
        "centers": ar.add(fm._centers),
        "kbt": float(fm._kbt),
        "spec": {
            "outer": spec.outer,
            "inner": spec.inner,
            "n_basis": spec.n_basis,
            "width": spec.width,
            "dist_power": spec.dist_power,
            "clip": spec.clip,
            "include_id": spec.include_id,
        },
        # scalar tags (solver_resid, escalated) survive the round trip;
        # coef_list is the same data as ``coefs`` and is rebuilt on decode
        "scalar_tags": {
            k: float(v)
            for k, v in fm.tags.items()
            if isinstance(v, (int, float, np.floating, np.integer))
        },
    }


def _decode_fused_gb(node: Dict[str, Any], data, device: torch.device) -> FusedGBMap:
    coefs = data[node["coefs"]]
    tags: Dict[str, Any] = dict(node.get("scalar_tags", {}))
    tags["coef_list"] = list(np.asarray(coefs))
    return FusedGBMap(
        coefs=coefs,
        cmap_mat=data[node["cmap_mat"]],
        onehot=data[node["onehot"]],
        centers=data[node["centers"]],
        kbt=node["kbt"],
        spec=GBFeatSpec(**node["spec"]),
        tags=tags,
        device=device,
    )


def _encode(tmap, ar: _Archive) -> Dict[str, Any]:
    if isinstance(tmap, SeperableTMap):
        return {
            "type": "SeperableTMap",
            "coord_map": _encode(tmap.coord_map, ar),
            "force_map": _encode(tmap.force_map, ar),
        }
    if isinstance(tmap, CLAFTMap):
        if not isinstance(tmap.force_map, FusedGBMap):
            raise ValueError(
                "Only CLAFTMaps with FusedGBMap force maps are serializable; "
                "protocol-featurizer CLAMaps capture arbitrary closures."
            )
        return {
            "type": "CLAFTMap",
            "coord_map": _encode(tmap.coord_map, ar),
            "force_map": _encode_fused_gb(tmap.force_map, ar),
        }
    if isinstance(tmap, AugmentedTMap):
        return {
            "type": "AugmentedTMap",
            "tmap": _encode(tmap.tmap, ar),
            "augmenter": _encode_augmenter(tmap.augmenter, ar),
            "kbt": float(tmap.kbt),
        }
    if isinstance(tmap, ComposedTMap):
        return {"type": "ComposedTMap", "submaps": [_encode(m, ar) for m in tmap.submaps]}
    if isinstance(tmap, NullForcesTMap):
        return {
            "type": "NullForcesTMap",
            "warn_input_forces": tmap.warn_input_forces,
            "fill_nan": bool(np.isnan(tmap.fill_value)),
            "fill_value": 0.0 if np.isnan(tmap.fill_value) else float(tmap.fill_value),
        }
    if isinstance(tmap, RATMap):
        return {"type": "RATMap", "tmap": _encode(tmap.tmap, ar)}
    if isinstance(tmap, LinearMap):
        return _encode_linear(tmap, ar)
    raise ValueError(f"Cannot serialize object of type {type(tmap)!r}.")


def _decode(node: Dict[str, Any], data, device: torch.device):
    t = node["type"]
    if t in ("LinearMap", "JLinearMap"):
        return _decode_linear(node, data, device)
    if t == "SeperableTMap":
        return SeperableTMap(
            coord_map=_decode(node["coord_map"], data, device),
            force_map=_decode(node["force_map"], data, device),
        )
    if t == "CLAFTMap":
        return CLAFTMap(
            coord_map=_decode(node["coord_map"], data, device),
            force_map=_decode_fused_gb(node["force_map"], data, device),
        )
    if t == "AugmentedTMap":
        return AugmentedTMap(
            aug_tmap=_decode(node["tmap"], data, device),
            augmenter=_decode_augmenter(node["augmenter"], data, device),
            kbt=node["kbt"],
        )
    if t == "ComposedTMap":
        return ComposedTMap([_decode(m, data, device) for m in node["submaps"]])
    if t == "NullForcesTMap":
        return NullForcesTMap(
            warn_input_forces=node["warn_input_forces"],
            fill_value=np.nan if node["fill_nan"] else node["fill_value"],
        )
    if t == "RATMap":
        return RATMap(tmap=_decode(node["tmap"], data, device))
    raise ValueError(f"Unknown node type {t!r} in archive.")


def save_tmap(path: str, tmap) -> None:
    """Serialize a TMap (or LinearMap) to a single .npz file."""
    ar = _Archive()
    tree = _encode(tmap, ar)
    np.savez_compressed(
        path, __tree__=np.frombuffer(json.dumps(tree).encode(), dtype=np.uint8),
        **ar.arrays,
    )


def load_tmap(path: str, device: DeviceLike = None):
    """Load a TMap saved by :func:`save_tmap` (of either package); its
    device maps and augmenters live on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    with np.load(path) as data:
        tree = json.loads(bytes(data["__tree__"].tobytes()).decode())
        return _decode(tree, data, dev)
