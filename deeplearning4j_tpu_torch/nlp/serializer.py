"""Word-vector serialization: the port of
`deeplearning4j_tpu/nlp/serializer.py`, under the same names and file
formats (a file written by either package reads in the other, bit-equal).

Parity with `models/embeddings/loader/WordVectorSerializer.java` (~2.5k LoC):
  * text format ("word v1 v2 ..." per line, optional count header)
  * Google word2vec binary format (header "V D\\n", then word + f32 LE vec)
  * zip "csv+metadata" model format (vectors.txt + config.json)
Readers return (VocabCache, lookup-table-like) wrapped in a WordVectorsModel
whose table lives on `device` (the GPU unless the caller passes
`device="cpu"`).
"""
from __future__ import annotations

import json
import zipfile

import numpy as np

from ..util.platform import DeviceLike
from .embeddings import InMemoryLookupTable, WordVectorsModel
from .vocab import VocabCache, VocabWord

__all__ = ["WordVectorSerializer"]


class WordVectorSerializer:
    # --------------------------- text ---------------------------------
    @staticmethod
    def _open_text(path: str, mode: str):
        """Transparent gzip (the reference's readWord2VecVectors gzip
        support): .gz extension on write; gzip MAGIC on read, so renamed
        .gz files still load."""
        import gzip

        if "r" in mode:
            with open(path, "rb") as probe:
                if probe.read(2) == b"\x1f\x8b":
                    return gzip.open(path, mode + "t", encoding="utf-8")
            return open(path, mode, encoding="utf-8")
        if path.endswith(".gz"):
            return gzip.open(path, mode + "t", encoding="utf-8")
        return open(path, mode, encoding="utf-8")

    @staticmethod
    def write_word_vectors(model: WordVectorsModel, path: str,
                           header: bool = False):
        m = model.lookup_table.vectors_matrix()
        words = model.vocab.words()
        with WordVectorSerializer._open_text(path, "w") as f:
            if header:
                f.write(f"{len(words)} {m.shape[1]}\n")
            for i, w in enumerate(words):
                vec = " ".join(f"{v:.6f}" for v in m[i])
                f.write(f"{w.replace(' ', '_')} {vec}\n")

    @staticmethod
    def read_word_vectors(path: str,
                          device: DeviceLike = None) -> WordVectorsModel:
        words, vecs = [], []
        with WordVectorSerializer._open_text(path, "r") as f:
            first = f.readline().rstrip("\n")
            parts = first.split(" ")
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pass  # header line
            elif parts:
                words.append(parts[0])
                vecs.append([float(v) for v in parts[1:]])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(v) for v in parts[1:]])
        return WordVectorSerializer._assemble(
            words, np.array(vecs, np.float32), device=device)

    # --------------------------- google binary -------------------------
    @staticmethod
    def write_binary(model: WordVectorsModel, path: str):
        m = model.lookup_table.vectors_matrix().astype("<f4")
        words = model.vocab.words()
        with open(path, "wb") as f:
            f.write(f"{len(words)} {m.shape[1]}\n".encode())
            for i, w in enumerate(words):
                f.write(w.replace(" ", "_").encode("utf-8") + b" ")
                f.write(m[i].tobytes())
                f.write(b"\n")

    @staticmethod
    def read_binary(path: str,
                    device: DeviceLike = None) -> WordVectorsModel:
        words, vecs = [], []
        with open(path, "rb") as f:
            header = f.readline().decode().strip().split()
            v, d = int(header[0]), int(header[1])
            for _ in range(v):
                chars = []
                while True:
                    c = f.read(1)
                    if c in (b" ", b""):
                        break
                    if c != b"\n":
                        chars.append(c)
                word = b"".join(chars).decode("utf-8", errors="replace")
                vec = np.frombuffer(f.read(4 * d), dtype="<f4")
                f.read(1)  # trailing newline
                words.append(word)
                vecs.append(vec)
        return WordVectorSerializer._assemble(
            words, np.array(vecs, np.float32), device=device)

    # --------------------------- zip model -----------------------------
    @staticmethod
    def write_word2vec_model(model, path: str):
        """Full model zip: vectors + config + counts (reference
        writeWord2VecModel)."""
        import io
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            buf = io.StringIO()
            m = model.lookup_table.vectors_matrix()
            for i, w in enumerate(model.vocab.words()):
                buf.write(f"{w.replace(' ', '_')} "
                          + " ".join(f"{v:.6f}" for v in m[i]) + "\n")
            z.writestr("syn0.txt", buf.getvalue())
            counts = {w: model.vocab.word_frequency(w)
                      for w in model.vocab.words()}
            labels = [vw.word for vw in model.vocab.vocab_words()
                      if vw.is_label]
            z.writestr("config.json", json.dumps({
                "layer_size": model.lookup_table.vector_length,
                "counts": counts, "labels": labels,
            }))

    @staticmethod
    def read_word2vec_model(path: str,
                            device: DeviceLike = None) -> WordVectorsModel:
        with zipfile.ZipFile(path) as z:
            cfg = json.loads(z.read("config.json").decode())
            words, vecs = [], []
            for line in z.read("syn0.txt").decode().splitlines():
                parts = line.split(" ")
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                vecs.append([float(v) for v in parts[1:]])
        model = WordVectorSerializer._assemble(
            words, np.array(vecs, np.float32), counts=cfg.get("counts"),
            labels=set(cfg.get("labels", [])), device=device)
        return model

    # -------------------------------------------------------------------
    @staticmethod
    def _assemble(words, matrix: np.ndarray, counts=None,
                  labels=None, device: DeviceLike = None) -> WordVectorsModel:
        vocab = VocabCache()
        for w in words:
            c = (counts or {}).get(w, 1.0)
            vocab.add_token(VocabWord(w, c, is_label=w in (labels or set())))
        # preserve file order as index order
        vocab._by_index = [vocab._words[w] for w in words]
        for i, vw in enumerate(vocab._by_index):
            vw.index = i
        vocab.total_word_count = float(sum(v.count for v in vocab._by_index))
        table = InMemoryLookupTable.from_arrays(vocab, matrix, negative=0,
                                                device=device)
        return WordVectorsModel(vocab, table)
