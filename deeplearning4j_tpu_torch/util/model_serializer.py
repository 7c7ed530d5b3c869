"""Model serialization: the JAX package's checkpoint zip, read and
written by the port (counterpart of
``deeplearning4j_tpu/util/model_serializer.py``).

The zip holds ``configuration.json``, ``coefficients.npz`` (arrays keyed
by their path in the params structure: ``1/attn/Wq``, ``3/b`` for a
MultiLayerNetwork's list, ``stem_conv/W``, ``stem_bn/gamma`` for a
ComputationGraph's dict by vertex name), ``updater_state.npz`` (the
updater's state under optax's own paths, e.g. ``0/.count``,
``0/.mu/1/attn/Wq``), ``state.npz`` (batch-norm statistics, e.g.
``stem_bn/mean``),
``metadata.json`` (counts, and the data normalizer's dict that
``write_model(..., normalizer=)`` was given, which
:func:`restore_normalizer` rebuilds) and ``manifest.json`` (CRC32 of
every other entry).
A zip either package writes restores in the other, and training
resumes from it in either. A zip whose updater state does not fit the
config's updater keeps the fresh state, as the JAX restore does. The
``checkpoint.write`` and ``checkpoint.read`` chaos sites sit where the
JAX package has them: on the file just written, and before the zip is
opened.
"""

from __future__ import annotations

import io
import json
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import chaos

__all__ = ["write_model", "snapshot_model", "write_snapshot",
           "restore_model", "restore_normalizer", "verify_checkpoint",
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


def params_from_jax(params: Union[List[Dict[str, Any]], Dict[str, Any]],
                    *, device="cuda"):
    """The JAX package's params or state (a MultiLayerNetwork's list of
    nested ``{name: array}`` dicts, or a ComputationGraph's dict of them
    by vertex name; numpy or jax arrays) as the port's: float32 tensors
    on ``device``, in the same structure. This is the one place the
    weight layout could change; it does not: both packages keep dense
    ``W`` as ``(n_in, n_out)`` for ``x @ W`` and conv ``W`` as HWIO
    (the port re-lays a conv kernel per call, not here)."""
    from deeplearning4j_tpu_torch.device import resolve_device
    dev = resolve_device(device)

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [conv(v) for v in tree]
        return torch.as_tensor(np.array(tree, np.float32), device=dev)

    return conv(params)


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


def _host_tree(tree):
    """``tree``'s tensors copied to host memory as numpy arrays, in the
    same structure. The copies are queued on the current stream
    (pinned, asynchronous) and waited for once."""
    cuda = []

    def to_host(leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.is_cuda:
            cuda.append(leaf.device)
            return leaf.detach().to("cpu", non_blocking=True)
        return leaf.detach().clone()      # a copy, not a view

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return to_host(t)

    out = walk(tree)
    for dev in set(cuda):
        torch.cuda.current_stream(dev).synchronize()

    def to_numpy(t):
        if isinstance(t, dict):
            return {k: to_numpy(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_numpy(v) for v in t]
        return t.numpy() if isinstance(t, torch.Tensor) else t
    return to_numpy(out)


def snapshot_model(model, *, save_updater: bool = True,
                   normalizer: Optional[dict] = None) -> Dict[str, Any]:
    """Device-to-host snapshot of everything :func:`write_model`
    persists, apart from serialization, so a background writer can do
    the expensive part off the train thread (the JAX package's
    ``snapshot_model``). The copies run on the current stream, after
    the steps queued before them; the call returns once they have
    landed. The dict is self-contained: later steps, or an optimizer
    rebuilt by an LR drop, cannot leak into a write in flight."""
    return {
        "conf_json": model.conf.to_json(),
        "params": _host_tree(model.params),
        "state": _host_tree(model.state if model.state is not None
                            else []),
        "opt_state": (_host_tree(model.opt_state)
                      if save_updater and model.opt_state is not None
                      else None),
        "meta": {
            "format_version": _FORMAT,
            "network_type": type(model).__name__,
            "iteration_count": int(model.iteration_count),
            "epoch_count": int(model.epoch_count),
            "normalizer": normalizer,
        },
    }


def write_snapshot(snap: Dict[str, Any], path: str, *,
                   extra_entries: Optional[Dict[str, Any]] = None
                   ) -> None:
    """Serialize a :func:`snapshot_model` dict to a checkpoint zip: npz
    packing, DEFLATE, the CRC32 manifest and the ``checkpoint.write``
    chaos site, on whatever thread calls it. ``extra_entries`` (name ->
    str or bytes) ride inside the zip and under the manifest's CRCs."""
    entries: Dict[str, bytes] = {
        "configuration.json": snap["conf_json"].encode(),
        "coefficients.npz": _save_npz(snap["params"]),
        "state.npz": _save_npz(snap["state"]),
    }
    if snap["opt_state"] is not None:
        entries["updater_state.npz"] = _save_npz(snap["opt_state"])
    entries["metadata.json"] = json.dumps(snap["meta"]).encode()
    for name, data in (extra_entries or {}).items():
        entries[name] = data if isinstance(data, bytes) \
            else str(data).encode()
    manifest = {"format_version": _FORMAT,
                "crc32": {n: zlib.crc32(d) & 0xFFFFFFFF
                          for n, d in entries.items()}}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in entries.items():
            z.writestr(name, data)
        z.writestr(_MANIFEST, json.dumps(manifest))
    # chaos site: a preemption/ENOSPC/bit-rot drill against the file
    # just written; restore-side verification must catch what it does
    chaos.file_fault("checkpoint.write", path)


def write_model(model, path: str, *, save_updater: bool = True,
                normalizer: Optional[dict] = None,
                extra_entries: Optional[Dict[str, Any]] = None) -> None:
    """Write ``model`` (a port MultiLayerNetwork or ComputationGraph) as
    a checkpoint zip, with its updater state when it has one and
    ``save_updater``. ``normalizer``: a data normalizer's ``to_dict()``
    (or None), kept in ``metadata.json`` as the JAX package keeps it.
    ``extra_entries`` as for :func:`write_snapshot`."""
    write_snapshot(snapshot_model(model, save_updater=save_updater,
                                  normalizer=normalizer),
                   path, extra_entries=extra_entries)


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
    """Rebuild a MultiLayerNetwork or ComputationGraph from a
    checkpoint zip (written by either package) on ``device``, with its
    updater state when the zip has one that fits the config's
    updater."""
    from deeplearning4j_tpu_torch.models.computation_graph import (
        ComputationGraph)
    from deeplearning4j_tpu_torch.models.multi_layer_network import (
        MultiLayerNetwork)
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import (
        MultiLayerConfiguration)

    # chaos site: at-rest rot / transient read failure found at restore
    # time (truncate/corrupt mutate the file before it is read)
    chaos.file_fault("checkpoint.read", path)
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json"))
        cfg = json.loads(z.read("configuration.json"))
        if cfg.get("network_type") == "ComputationGraph":
            model = ComputationGraph(
                ComputationGraphConfiguration.from_dict(cfg), device=device)
        else:
            model = MultiLayerNetwork(
                MultiLayerConfiguration.from_dict(cfg), device=device)
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


def restore_normalizer(path: str):
    """The data normalizer that ``write_model(..., normalizer=)`` (of
    either package) kept in the zip, rebuilt; None if it has none."""
    from deeplearning4j_tpu_torch.data.normalizers import (
        normalizer_from_dict)
    with zipfile.ZipFile(path, "r") as z:
        meta = json.loads(z.read("metadata.json"))
    return normalizer_from_dict(meta.get("normalizer"))
