"""Model serialization: the JAX package's checkpoint zip, read and
written by the port (counterpart of
``deeplearning4j_tpu/util/model_serializer.py``).

The zip holds ``configuration.json``, ``coefficients.npz`` (arrays keyed
by their path in the params structure, e.g. ``1/attn/Wq``, ``3/b``),
``updater_state.npz`` (the updater's state under optax's own paths,
e.g. ``0/.count``, ``0/.mu/1/attn/Wq``), ``state.npz``,
``metadata.json`` and ``manifest.json`` (CRC32 of every other entry).
A zip either package writes restores in the other, and training
resumes from it in either. A zip whose updater state does not fit the
config's updater keeps the fresh state, as the JAX restore does.
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from typing import Any, Dict, List

import numpy as np
import torch

__all__ = ["write_model", "restore_model", "verify_checkpoint",
           "params_from_jax", "CheckpointIntegrityError"]

_FORMAT = 1
_MANIFEST = "manifest.json"


class CheckpointIntegrityError(RuntimeError):
    """The checkpoint file failed CRC/structure verification
    (truncated write, bit rot, interrupted copy)."""


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    items = (enumerate(tree) if isinstance(tree, (list, tuple))
             else sorted(tree.items()))
    flat = {}
    for key, leaf in items:
        path = f"{prefix}{key}"
        if isinstance(leaf, (dict, list, tuple)):
            flat.update(_flatten(leaf, path + "/"))
        else:
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().numpy()
            flat[path] = np.asarray(leaf)
    return flat


def _save_npz(tree) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_flatten(tree))
    return buf.getvalue()


def params_from_jax(params: List[Dict[str, Any]], *, device="cuda"
                    ) -> List[Dict[str, Any]]:
    """The JAX package's params (a list of nested ``{name: array}``
    dicts, numpy or jax arrays) as the port's: float32 tensors on
    ``device``. This is the one place the weight layout could change;
    it does not: both packages keep ``W`` as ``(n_in, n_out)`` for
    ``x @ W``."""
    from deeplearning4j_tpu_torch.device import resolve_device
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return torch.as_tensor(np.array(tree, np.float32), device=dev)

    return [conv(p) for p in params]


def _unflatten_like(flat: Dict[str, np.ndarray], template, prefix=""):
    """The arrays of ``flat`` in the structure of ``template``, checked
    key by key and shape by shape."""
    items = (enumerate(template) if isinstance(template, list)
             else template.items())
    out = [] if isinstance(template, list) else {}
    for key, leaf in items:
        path = f"{prefix}{key}"
        if isinstance(leaf, (dict, list)):
            value = _unflatten_like(flat, leaf, path + "/")
        else:
            if path not in flat:
                raise KeyError(f"Checkpoint missing array '{path}'")
            value = flat[path]
            if tuple(value.shape) != tuple(leaf.shape):
                raise ValueError(f"Checkpoint array '{path}' has shape "
                                 f"{tuple(value.shape)}, the config "
                                 f"expects {tuple(leaf.shape)}")
        if isinstance(out, list):
            out.append(value)
        else:
            out[key] = value
    return out


def _tensors_like(tree, template):
    """``tree`` (numpy leaves) as tensors of the template's leaf dtypes
    and devices."""
    if isinstance(template, dict):
        return {k: _tensors_like(tree[k], v) for k, v in template.items()}
    if isinstance(template, list):
        return [_tensors_like(a, v) for a, v in zip(tree, template)]
    return torch.as_tensor(np.asarray(tree), dtype=template.dtype,
                           device=template.device)


def write_model(model, path: str) -> None:
    """Write ``model`` (a port MultiLayerNetwork) as a checkpoint zip,
    with its updater state when it has one."""
    entries: Dict[str, bytes] = {
        "configuration.json": model.conf.to_json().encode(),
        "coefficients.npz": _save_npz(model.params),
        "state.npz": _save_npz(model.state or []),
    }
    if model.opt_state is not None:
        entries["updater_state.npz"] = _save_npz(model.opt_state)
    entries.update({
        "metadata.json": json.dumps({
            "format_version": _FORMAT,
            "network_type": type(model).__name__,
            "iteration_count": int(model.iteration_count),
            "epoch_count": int(model.epoch_count),
            "normalizer": None,
        }).encode(),
    })
    manifest = {"format_version": _FORMAT,
                "crc32": {n: zlib.crc32(d) & 0xFFFFFFFF
                          for n, d in entries.items()}}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in entries.items():
            z.writestr(name, data)
        z.writestr(_MANIFEST, json.dumps(manifest))


def verify_checkpoint(path: str) -> dict:
    """Integrity-check a checkpoint zip without building a model: every
    manifested entry is re-read and its CRC32 recomputed (zips without
    a manifest fall back to the zip's own CRCs). Corruption raises
    :class:`CheckpointIntegrityError`; a missing file raises the
    original ``OSError``. Returns the manifest ({} without one)."""
    try:
        with zipfile.ZipFile(path, "r") as z:
            names = set(z.namelist())
            for required in ("metadata.json", "configuration.json",
                             "coefficients.npz"):
                if required not in names:
                    raise CheckpointIntegrityError(
                        f"{path}: required entry {required!r} is missing "
                        "(interrupted write?)")
            if _MANIFEST not in names:
                bad = z.testzip()
                if bad is not None:
                    raise CheckpointIntegrityError(
                        f"{path}: entry {bad!r} fails its zip CRC")
                return {}
            manifest = json.loads(z.read(_MANIFEST))
            for name, crc in manifest.get("crc32", {}).items():
                if name not in names:
                    raise CheckpointIntegrityError(
                        f"{path}: entry {name!r} is in the manifest but "
                        "missing from the zip")
                actual = 0
                with z.open(name) as fh:
                    while chunk := fh.read(1 << 20):
                        actual = zlib.crc32(chunk, actual)
                actual &= 0xFFFFFFFF
                if actual != int(crc):
                    raise CheckpointIntegrityError(
                        f"{path}: entry {name!r} CRC mismatch (manifest "
                        f"{int(crc):#010x}, actual {actual:#010x})")
            return manifest
    except (zipfile.BadZipFile, zlib.error, EOFError,
            json.JSONDecodeError) as e:
        raise CheckpointIntegrityError(
            f"{path} is not a readable checkpoint zip: {e!r}") from e


def restore_model(path: str, *, device="cuda"):
    """Rebuild a MultiLayerNetwork from a checkpoint zip (written by
    either package) on ``device``, with its updater state when the zip
    has one that fits the config's updater."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)

    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json"))
        cfg = json.loads(z.read("configuration.json"))
        if cfg.get("network_type", "MultiLayerNetwork") \
                != "MultiLayerNetwork":
            raise NotImplementedError(
                f"{cfg['network_type']} is not ported to "
                "deeplearning4j_tpu_torch yet")
        model = MultiLayerNetwork(MultiLayerConfiguration.from_dict(cfg),
                                  device=device)
        # the config's own params give the structure and shapes to check
        template, state_template = model._sample_params(0)
        arrays = {}
        entries = ["coefficients.npz", "state.npz"]
        if "updater_state.npz" in z.namelist():
            entries.append("updater_state.npz")
        for entry in entries:
            with np.load(io.BytesIO(z.read(entry))) as arch:
                arrays[entry] = {k: arch[k] for k in arch.files}
    model.set_params(params_from_jax(
        _unflatten_like(arrays["coefficients.npz"], template),
        device=device))
    model.state = params_from_jax(
        _unflatten_like(arrays["state.npz"], state_template),
        device=device)
    model._build_optimizer()
    if "updater_state.npz" in arrays:
        try:
            model.opt_state = _tensors_like(
                _unflatten_like(arrays["updater_state.npz"],
                                model.opt_state), model.opt_state)
        except KeyError:
            pass    # the optimizer config changed: keep the fresh state
    model.iteration_count = meta.get("iteration_count", 0)
    model.epoch_count = meta.get("epoch_count", 0)
    return model
