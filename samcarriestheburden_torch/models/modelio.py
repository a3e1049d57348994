"""Model files with their architecture config, and the local model registry
(JAX ``models/modelio.py``, reference custom_arcitecture/modelio.py:10-86).

The file format is the JAX package's: one ``.npz`` holds the params pytree
flattened to '/'-joined keys (the JAX package's layout: HWIO convolutions,
the U-Net of :func:`convert.unet_params_from_torch`) and a JSON config header
under ``__config__``.  A file or registry either package writes loads in the
other, and the same weights get the same registry id in both.
"""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from samcarriestheburden_torch.config import SamConfig, UNetConfig
from samcarriestheburden_torch.models import convert
from samcarriestheburden_torch.models.unet import build_unet

_CONFIG_CLASSES = {"UNetConfig": UNetConfig, "SamConfig": SamConfig}


# ---------------------------------------------------------------------------
# pytree <-> flat npz
# ---------------------------------------------------------------------------


def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for path, value in flat.items():
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _as_params(config, params):
    """``params`` as the JAX package's pytree: a U-Net module or state dict
    is converted (:func:`convert.unet_params_from_torch`), a pytree kept."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(config, UNetConfig) and "outc.conv.weight" in params:
        return convert.unet_params_from_torch(params, config)
    return params


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_model(path, config, params) -> Path:
    """Write a config-bundled checkpoint (LoadableModel.save semantics,
    reference modelio.py:67-76).  ``params``: the JAX package's pytree, or
    for a :class:`UNetConfig` a ``UNet`` or its state dict."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = flatten_params(_as_params(config, params))
    flat["__config__"] = np.frombuffer(
        json.dumps({"class": type(config).__name__,
                    "config": json.loads(config.to_json())}).encode(), dtype=np.uint8)
    np.savez(path, **flat)
    return path


def load_model(path) -> Tuple[Any, dict]:
    """(config, params pytree of numpy arrays) from a bundle (LoadableModel.load
    semantics, reference modelio.py:78-86)."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__config__"].tobytes()).decode())
        params = unflatten_params({k: data[k] for k in data.files if k != "__config__"})
    config = _CONFIG_CLASSES[header["class"]].from_json(json.dumps(header["config"]))
    return config, params


def save_params(path, params) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten_params(params))
    return path


def load_params(path):
    with np.load(path, allow_pickle=False) as data:
        return unflatten_params({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# local model registry (replaces ClearML model ids)
# ---------------------------------------------------------------------------


class ModelRegistry:
    """Content-addressed model store: ``register`` returns a stable hex id,
    ``get_weights(model_id)`` the checkpoint's path, ``load(model_id)`` the
    model itself: the operations the reference performs against ClearML."""

    def __init__(self, root="data/model_registry"):
        self.root = Path(root)

    def register(self, config, params, name: str = "model",
                 metadata: Optional[dict] = None) -> str:
        params = _as_params(config, params)
        flat = flatten_params(params)
        h = hashlib.sha256()
        for k in sorted(flat):
            h.update(k.encode())
            h.update(np.ascontiguousarray(flat[k]).tobytes())
        model_id = h.hexdigest()[:32]
        mdir = self.root / model_id
        mdir.mkdir(parents=True, exist_ok=True)
        save_model(mdir / "model.npz", config, params)
        meta = {"name": name, "created": time.time(), **(metadata or {})}
        (mdir / "meta.json").write_text(json.dumps(meta, indent=2))
        return model_id

    def get_weights(self, model_id: str) -> Path:
        path = self.root / model_id / "model.npz"
        if not path.exists():
            raise KeyError(f"model id {model_id!r} not found under {self.root}")
        return path

    def load(self, model_id: str, device=None):
        """(UNetConfig, ``UNet`` in eval mode on ``device``); ``device=None``
        is the card (raises without one)."""
        config, params = load_model(self.get_weights(model_id))
        if not isinstance(config, UNetConfig):
            raise ValueError(f"model {model_id!r} is a {type(config).__name__}, not a U-Net")
        sd = convert.unet_state_dict_from_jax(params, config)
        return config, build_unet(config, device=device, state_dict=sd)

    def list(self):
        out = []
        for mdir in sorted(self.root.glob("*/meta.json")):
            meta = json.loads(mdir.read_text())
            out.append({"id": mdir.parent.name, **meta})
        return out
