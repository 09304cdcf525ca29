"""Model checkpoint zip, the same container `deeplearning4j_tpu/util/serializer.py`
writes, so a model saved by either package loads in the other:

  * `configuration.json`   — the network config (identical JSON)
  * `coefficients.npz`     — parameters, keyed `i:<layer>/k:<param>`
                             (a ComputationGraph's `k:<vertex>/k:<param>`)
  * `networkState.npz`     — layer state, keyed `i:<layer>/k:<name>`
                             (BatchNormalization's `i:1/k:mean`, `k:var`)
  * `updaterState.npz`     — optimizer state, keyed `i:<layer>/k:<slot>/
                             k:<param>` (`i:0/k:m/k:W`)
  * `metadata.json`        — counters and model kind (a checkpoint adds
                             its bookkeeping, and the states of the
                             dropout generators under `torch_generators`)
  * `manifest.sha256.json` — sha256 of every other entry, checked on restore

Both model kinds, MultiLayerNetwork and ComputationGraph, are written and
restored (`metadata.json`'s `kind` picks the class). Writes are crash-safe
(fault/atomic.py), with the `zip/temp_written` crash point of
fault/injection.py; `restore_into` restores a checkpoint into a model that
already exists (the resume path). `ModelGuesser` sniffs a model file's
format and loads it (a zip, or a Keras HDF5 file through `modelimport/`). `from_jax_params` loads the JAX model's parameters (and
optionally its layer state and updater state), as numpy arrays, straight
into a port network or graph.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from ..fault.atomic import CorruptCheckpointError, atomic_replace, sha256_hex
from ..util.platform import DeviceLike

__all__ = ["ModelSerializer", "ModelGuesser", "tree_to_arrays",
           "arrays_to_tree", "from_jax_params"]


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + [f"k:{k}"], out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, prefix + [f"i:{i}"], out)
    else:
        out["/".join(prefix)] = tree


def tree_to_arrays(tree) -> Dict[str, np.ndarray]:
    """Flatten a tuple of per-layer dicts to {path: array}, with the key
    paths JAX's `tree_flatten_with_path` gives (`i:0/k:W`)."""
    flat: Dict = {}
    _flatten(tree, [], flat)
    # numpy has no bfloat16: such tensors (Adam's m with state_dtype
    # "bfloat16") are written as float32, which holds them exactly
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in flat.items()}


def arrays_to_tree(template, arrays: Dict[str, np.ndarray]):
    """Rebuild a tree shaped like `template` (tensors give shape, dtype and
    device) from {path: array}; raises on a missing key or a wrong shape."""
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(t[k], prefix + [f"k:{k}"]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, prefix + [f"i:{i}"])
                           for i, v in enumerate(t))
        key = "/".join(prefix)
        if key not in arrays:
            raise KeyError(f"Checkpoint missing array '{key}'")
        arr = np.asarray(arrays[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"Checkpoint shape mismatch at '{key}': "
                             f"{arr.shape} vs {tuple(t.shape)}")
        return torch.tensor(arr, dtype=t.dtype, device=t.device)   # a copy
    return build(template, [])


def from_jax_params(net, params, updater_state=None, state=None):
    """Load the JAX model's parameters into `net`, which must be
    initialized: for a MultiLayerNetwork one dict of numpy arrays per layer
    (keyed as in JAX), for a ComputationGraph a dict keyed by vertex name.
    With `updater_state` (JAX's `updater_state` with numpy leaves: per layer
    or vertex `{"m": {"W": ...}, ...}` or `()`) its updater state, and with
    `state` (JAX's `state`: BatchNormalization's `{"mean", "var"}`, `{}`
    for the others) its layer state too. Shapes are checked; a missing key
    raises KeyError."""
    trees = (("parameter", params, "params"),
             ("updater state", updater_state, "updater_state"),
             ("layer state", state, "state"))
    graph = isinstance(net.params, dict)
    for what, tree, _ in trees:
        if tree is None:
            continue
        if graph and set(tree) != set(net.params):
            raise ValueError(f"{what} dicts for vertices {sorted(tree)}; "
                             f"the graph has {sorted(net.params)}")
        if not graph and len(tree) != len(net.params):
            raise ValueError(f"{len(tree)} layer {what} dicts for a "
                             f"{len(net.params)}-layer network")
    for _, tree, attr in trees:
        if tree is not None:
            arrays: Dict = {}
            _flatten(dict(tree) if graph else list(tree), [], arrays)
            setattr(net, attr, arrays_to_tree(getattr(net, attr), arrays))
    return net


def _savez(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _loadz(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class ModelSerializer:
    CONFIG = "configuration.json"
    COEFFICIENTS = "coefficients.npz"
    UPDATER_STATE = "updaterState.npz"
    NETWORK_STATE = "networkState.npz"
    METADATA = "metadata.json"
    MANIFEST = "manifest.sha256.json"

    @staticmethod
    def write_model(model, path: str, save_updater: bool = True,
                    extra_meta: Optional[Dict] = None):
        """Write a MultiLayerNetwork or ComputationGraph to a zip,
        crash-safely, with a sha256 manifest of every entry; with
        `save_updater`, its updater state too. `extra_meta` merges into
        metadata.json (checkpoint bookkeeping: score, epoch-in-fit, ...)."""
        from ..fault.metrics import checkpoint_timer

        meta = {"kind": type(model).__name__,
                "iteration_count": model.iteration_count,
                "epoch_count": model.epoch_count,
                "format_version": 1}
        gens = _generator_meta(model)
        if gens is not None:
            meta["torch_generators"] = gens
        if extra_meta:
            meta.update(extra_meta)
        entries = [(ModelSerializer.CONFIG, model.conf.to_json().encode()),
                   (ModelSerializer.COEFFICIENTS,
                    _savez(tree_to_arrays(model.params))),
                   (ModelSerializer.NETWORK_STATE,
                    _savez(tree_to_arrays(model.state)))]
        if save_updater and model.updater_state is not None:
            entries.append((ModelSerializer.UPDATER_STATE,
                            _savez(tree_to_arrays(model.updater_state))))
        entries.append((ModelSerializer.METADATA, json.dumps(meta).encode()))
        manifest = {"sha256": {name: sha256_hex(data)
                               for name, data in entries},
                    "format_version": 1}
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
            for name, data in entries:
                z.writestr(name, data)
            z.writestr(ModelSerializer.MANIFEST, json.dumps(manifest))
        with checkpoint_timer("save", "zip"):
            atomic_replace(path, buf.getvalue(),
                           crash_point="zip/temp_written")

    @staticmethod
    def _read_verified(path: str) -> Dict[str, bytes]:
        """Every entry, checked against the manifest (zips without one
        pass: there is nothing to check against)."""
        with zipfile.ZipFile(path) as z:
            entries = {n: z.read(n) for n in z.namelist()}
        raw = entries.pop(ModelSerializer.MANIFEST, None)
        if raw is None:
            return entries
        want = json.loads(raw.decode()).get("sha256", {})
        missing = set(want) - set(entries)
        if missing:
            raise CorruptCheckpointError(
                f"{path}: manifest lists entries missing from the zip: "
                f"{sorted(missing)}")
        for name in sorted(entries):
            if name in want and sha256_hex(entries[name]) != want[name]:
                raise CorruptCheckpointError(
                    f"{path}: sha256 mismatch for entry '{name}' — "
                    "checkpoint is corrupt (torn copy or bit rot)")
        return entries

    @staticmethod
    def restore(path: str, load_updater: bool = True,
                device: DeviceLike = None):
        """Restore a MultiLayerNetwork or ComputationGraph zip onto
        `device` (the GPU unless the caller asks for the CPU): parameters,
        layer state, and with `load_updater` its updater state where the
        zip has one (else the updater's zero state)."""
        from ..nn.conf import MultiLayerConfiguration
        from ..nn.conf.graph import ComputationGraphConfiguration
        from ..nn.graph import ComputationGraph
        from ..nn.multilayer import MultiLayerNetwork

        entries = ModelSerializer._read_verified(path)
        meta = json.loads(entries[ModelSerializer.METADATA].decode())
        kind = meta.get("kind", "MultiLayerNetwork")
        config = entries[ModelSerializer.CONFIG].decode()
        if kind == "ComputationGraph":
            model = ComputationGraph(
                ComputationGraphConfiguration.from_json(config),
                device=device).init()
        elif kind == "MultiLayerNetwork":
            model = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(config),
                device=device).init()
        else:
            raise ValueError(f"{path}: unknown model kind {kind!r}")
        ModelSerializer._restore_into(model, entries, load_updater)
        return model

    @staticmethod
    def restore_into(model, path: str, load_updater: bool = True) -> Dict:
        """Restore a checkpoint into an already-initialised model of the
        same architecture (the resume path: no config parse, no init), on
        the model's device. Verifies the manifest first. Returns the
        metadata dict (counters, checkpoint extras)."""
        from ..fault.metrics import checkpoint_timer

        with checkpoint_timer("restore", "zip"):
            entries = ModelSerializer._read_verified(path)
            return ModelSerializer._restore_into(model, entries,
                                                 load_updater)

    @staticmethod
    def _restore_into(model, entries: Dict[str, bytes],
                      load_updater: bool) -> Dict:
        meta = json.loads(entries[ModelSerializer.METADATA].decode())
        model.params = arrays_to_tree(
            model.params, _loadz(entries[ModelSerializer.COEFFICIENTS]))
        if ModelSerializer.NETWORK_STATE in entries:
            model.state = arrays_to_tree(
                model.state, _loadz(entries[ModelSerializer.NETWORK_STATE]))
        if load_updater and ModelSerializer.UPDATER_STATE in entries:
            model.updater_state = arrays_to_tree(
                model.updater_state,
                _loadz(entries[ModelSerializer.UPDATER_STATE]))
        model.iteration_count = meta.get("iteration_count", 0)
        model.epoch_count = meta.get("epoch_count", 0)
        _restore_generators(model, meta.get("torch_generators"))
        return meta


def _generator_slots(model):
    """(attribute, is_list) of the model's dropout generators: a network's
    `_generator` and `_pretrain_gen`, a graph's `_generators` list."""
    if hasattr(model, "_generators"):
        return [("_generators", True)]
    return [("_generator", False), ("_pretrain_gen", False)]


def _gen_state(g):
    return None if g is None else bytes(g.get_state().numpy()).hex()


def _generator_meta(model) -> Optional[Dict]:
    """The dropout generators' states for metadata.json, with the device
    kind that drew them (a state restores only on the same kind)."""
    out = {}
    for attr, is_list in _generator_slots(model):
        g = getattr(model, attr, None)
        out[attr] = ([_gen_state(x) for x in g] if is_list and g is not None
                     else _gen_state(g) if not is_list else None)
    if all(v is None for v in out.values()):
        return None
    return {"device": model.device.type, "states": out}


def _from_hex(h: str) -> torch.Tensor:
    return torch.frombuffer(bytearray.fromhex(h), dtype=torch.uint8).clone()


def _put_state(cur, h, device):
    """A generator on `device` holding state `h` (`cur` itself, in place,
    when it exists: a captured CUDA graph keeps the generator it was
    captured with), or None when `h` is None."""
    if h is None:
        return None
    g = cur if cur is not None else torch.Generator(device=device)
    g.set_state(_from_hex(h))
    return g


def _restore_generators(model, rec: Optional[Dict]):
    """Put back the generator states `write_model` recorded, when they
    were drawn on the model's device kind; a zip without them (a JAX
    checkpoint, or a model that never drew) leaves the generators unset,
    so they start from the seed as in a fresh run."""
    slots = _generator_slots(model)
    if rec is None or rec.get("device") != model.device.type:
        for attr, _ in slots:
            setattr(model, attr, None)
        return
    states = rec.get("states", {})
    for attr, is_list in slots:
        h = states.get(attr)
        cur = getattr(model, attr, None)
        if is_list:
            if h is None:
                setattr(model, attr, None)
            else:
                cur = cur if cur is not None and len(cur) == len(h) \
                    else [None] * len(h)
                setattr(model, attr, [_put_state(c, x, model.device)
                                      for c, x in zip(cur, h)])
        else:
            setattr(model, attr, _put_state(cur, h, model.device))


class ModelGuesser:
    """Format sniffing and dispatch loading (reference `ModelGuesser.java`;
    the port of the JAX package's `util/serializer.ModelGuesser`): given a
    model file, detect what it is and load it with the right loader onto
    `device` (the GPU unless the caller passes `device="cpu"`).

    Recognized: ModelSerializer zips (MultiLayerNetwork or
    ComputationGraph), Keras HDF5 models (Sequential or functional, through
    `modelimport/`), and word-vector files (Google binary, text with or
    without a header and gzipped or not, the word2vec zip), loaded through
    `nlp.serializer.WordVectorSerializer` as a `WordVectorsModel`."""

    WORD_VECTOR_KINDS = ("word_vectors_binary", "word_vectors_text",
                         "word_vectors_zip")

    @staticmethod
    def _sniff_vector_bytes(head: bytes) -> Optional[str]:
        """Classify a word-vector payload from its first bytes."""
        try:
            first_line, _, rest = head.partition(b"\n")
            tokens = first_line.decode("utf-8").strip().split()
        except UnicodeDecodeError:
            return None
        if len(tokens) == 2 and all(t.isdigit() for t in tokens):
            # "<V> <D>\n" header: Google binary OR text-with-header.
            # Binary payload after the word is raw f32; text stays ASCII.
            printable = sum(32 <= b < 127 or b in (9, 10, 13)
                            for b in rest)
            return ("word_vectors_text" if rest and
                    printable / len(rest) > 0.95 else
                    "word_vectors_binary")
        if len(tokens) >= 2:
            try:
                float(tokens[1])
                return "word_vectors_text"
            except ValueError:
                return None
        return None

    @staticmethod
    def guess_format(path: str) -> str:
        with open(path, "rb") as f:
            head = f.read(4096)
        if head[:4] == b"PK\x03\x04":
            with zipfile.ZipFile(path) as z:
                names = set(z.namelist())
            if "configuration.json" in names:
                return "dl4j_tpu_zip"
            if "syn0.txt" in names and "config.json" in names:
                return "word_vectors_zip"
            return "unknown_zip"
        if head[:8] == b"\x89HDF\r\n\x1a\n":
            return "keras_h5"
        if head[:2] == b"\x1f\x8b":
            # gzipped text vectors
            import gzip
            try:
                inner = gzip.GzipFile(fileobj=io.BytesIO(head)).read(1024)
            except (OSError, EOFError):
                return "unknown"
            kind = ModelGuesser._sniff_vector_bytes(inner)
            return kind or "unknown"
        kind = ModelGuesser._sniff_vector_bytes(head)
        return kind or "unknown"

    @staticmethod
    def load(path: str, device: DeviceLike = None):
        kind = ModelGuesser.guess_format(path)
        if kind == "dl4j_tpu_zip":
            return ModelSerializer.restore(path, device=device)
        if kind == "keras_h5":
            from ..modelimport.keras import (
                KerasImportError, import_keras_model_and_weights,
                import_keras_sequential_model_and_weights)
            try:
                return import_keras_sequential_model_and_weights(path,
                                                                 device)
            except KerasImportError as e:
                if "Not a Sequential model" not in str(e):
                    raise   # keep the actionable sequential-import error
                return import_keras_model_and_weights(path, device)
        if kind in ModelGuesser.WORD_VECTOR_KINDS:
            from ..nlp.serializer import WordVectorSerializer as S
            read = {"word_vectors_binary": S.read_binary,
                    "word_vectors_text": S.read_word_vectors,
                    "word_vectors_zip": S.read_word2vec_model}[kind]
            return read(path, device=device)
        raise ValueError(f"cannot determine model format of {path!r} "
                         f"(sniffed: {kind})")
