"""ModelGuesser: sniff a file and load it with the right loader
(counterpart of ``deeplearning4j_tpu/util/model_guesser.py``).

Mirrors deeplearning4j-core util/ModelGuesser.java (194 LoC): given a
path, detect framework checkpoint zip vs Keras HDF5 vs word-vector
text, and load accordingly: a network on ``device``, or word vectors
as ``(VocabCache, numpy table)`` (``nlp.serializer.read_word_vectors``).
"""

from __future__ import annotations

import zipfile

__all__ = ["guess_format", "load_model_guess"]


def guess_format(path: str) -> str:
    """'checkpoint' | 'keras_h5' | 'word_vectors' | 'unknown'."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:4] == b"PK\x03\x04":
        try:
            with zipfile.ZipFile(path) as z:
                names = z.namelist()
            if "configuration.json" in names:
                return "checkpoint"
        except zipfile.BadZipFile:
            pass
        return "unknown"
    if magic[:8] == b"\x89HDF\r\n\x1a\n":
        return "keras_h5"
    try:
        head = magic.decode().split()
        if len(head) >= 1 and head[0].isdigit():
            return "word_vectors"
    except UnicodeDecodeError:
        pass
    return "unknown"


def load_model_guess(path: str, *, device="cuda"):
    """The network in ``path`` (a checkpoint zip or a Keras ``.h5``) on
    ``device``, or the word vectors of a ``.vec`` text file (host
    arrays, as the JAX package returns them)."""
    kind = guess_format(path)
    if kind == "checkpoint":
        from deeplearning4j_tpu_torch.util.model_serializer import (
            restore_model)
        return restore_model(path, device=device)
    if kind == "keras_h5":
        from deeplearning4j_tpu_torch.keras import (
            import_keras_model_and_weights)
        return import_keras_model_and_weights(path, device=device)
    if kind == "word_vectors":
        from deeplearning4j_tpu_torch.nlp.serializer import read_word_vectors
        return read_word_vectors(path)
    raise ValueError(f"Cannot determine model format of {path}")
