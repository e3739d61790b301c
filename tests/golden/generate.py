"""Generate the committed reference-parity corpus (tests/golden/).

Sequences come from tools/refgen.cpp -- byte-identical to what a real
reference binary's `align -r min max` random mode draws (main.cpp:200-211,
default-seeded mt19937_64, libstdc++ distribution semantics). Expected
results are produced by the native C oracle (native/anyseq_native.cpp, an
independent non-JAX implementation of the reference recurrence) and
cross-checked against the numpy oracle (ref/oracle.py) before being
written; a mismatch aborts generation.

Run from the repo root:  python tests/golden/generate.py

The committed artifacts (pairs_*.fna + golden.json) are consumed by
tests/test_golden.py, and by `python -m anyseq_tpu.cli --parity` when a
real reference binary (or its recorded output) is available.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

# Shape classes: random-mode shapes (reference main.cpp defaults are
# min=1000 max=10000; benchmark.sh pairs are Mbp genomes -- represented
# here at committed-file-friendly sizes). npairs > 1 documents RNG
# continuation across draws.
CLASSES = [
    {"minlen": 64, "maxlen": 128, "npairs": 4},
    {"minlen": 1000, "maxlen": 1000, "npairs": 2},
    {"minlen": 1000, "maxlen": 10000, "npairs": 1},  # reference defaults
    {"minlen": 4000, "maxlen": 4000, "npairs": 1},
    # >= 10k: several 128 x 128 tiles of the GPU sweep kernel in each
    # direction.
    {"minlen": 12000, "maxlen": 12000, "npairs": 1},
]
MODES = ["global", "semiglobal", "local"]


def build_refgen() -> str:
    exe = os.path.join(HERE, "_refgen")
    src = os.path.join(ROOT, "tools", "refgen.cpp")
    if (not os.path.exists(exe)
            or os.path.getmtime(exe) < os.path.getmtime(src)):
        subprocess.run(["g++", "-O2", "-o", exe, src], check=True)
    return exe


def read_pairs(fasta_text: str):
    seqs = []
    cur = []
    for line in fasta_text.splitlines():
        if line.startswith(">"):
            if cur:
                seqs.append("".join(cur))
                cur = []
        else:
            cur.append(line.strip())
    if cur:
        seqs.append("".join(cur))
    return [(seqs[i], seqs[i + 1]) for i in range(0, len(seqs) - 1, 2)]


def native_lib():
    from anyseq_tpu.io import _native

    lib = _native.get_lib()
    if lib is None:
        raise SystemExit("native oracle unavailable (g++ missing?)")
    for name in MODES:
        fn = getattr(lib, f"{name}_alignment_score")
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int,
                       ctypes.c_char_p, ctypes.c_int]
        for suffix in ("", "_fulltb"):
            cf = getattr(lib, f"construct_{name}_alignment{suffix}")
            cf.restype = ctypes.c_int64
            cf.argtypes = [ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_char_p, ctypes.c_int,
                           ctypes.c_char_p, ctypes.c_char_p]
    return lib


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from anyseq_tpu.core.types import LinearScoring, Mode
    from anyseq_tpu.ref import oracle

    SC = LinearScoring(2, -1, -1)
    exe = build_refgen()
    lib = native_lib()

    out = {
        "generator": "tools/refgen.cpp (libstdc++ std::mt19937_64, "
                     "default seed; reference main.cpp:200-211 semantics)",
        "scoring": {"match": 2, "mismatch": -1, "gap": -1},
        "alignment_encoding": "sparse output with EMPTY_SYM (' ') "
                              "stripped; '_' = gap (traceback.impala:1-2)",
        "classes": [],
    }

    for cls in CLASSES:
        args = [exe, str(cls["minlen"]), str(cls["maxlen"]),
                str(cls["npairs"])]
        fasta = subprocess.run(args, check=True, capture_output=True,
                               text=True).stdout
        fname = f"pairs_{cls['minlen']}x{cls['maxlen']}.fna"
        with open(os.path.join(HERE, fname), "w") as f:
            f.write(fasta)
        entry = {
            **cls,
            "fasta": fname,
            "fasta_sha256": hashlib.sha256(
                fasta.encode()).hexdigest(),
            "pairs": [],
        }
        for k, (q, s) in enumerate(read_pairs(fasta)):
            qb, sb = q.encode(), s.encode()
            rec = {"k": k, "m": len(q), "n": len(s), "scores": {},
                   "alignments": {}}
            for name in MODES:
                mode = Mode.parse(name)
                c_score = getattr(lib, f"{name}_alignment_score")(
                    qb, len(qb), sb, len(sb))
                np_score = oracle.align_score(qb, sb, mode, SC)
                assert c_score == np_score, (
                    f"oracle disagreement {name} pair {k}: "
                    f"C={c_score} numpy={np_score}")
                rec["scores"][name] = int(c_score)
                # alignments only for small pairs (oracle is O(m*n))
                if len(q) <= 1100 and len(s) <= 1100:
                    alq = ctypes.create_string_buffer(len(q) + len(s))
                    als = ctypes.create_string_buffer(len(q) + len(s))
                    cscore2 = getattr(
                        lib, f"construct_{name}_alignment")(
                        qb, len(qb), sb, len(sb), alq, als)
                    assert cscore2 == c_score
                    escore, eq, es, _ = oracle.align(qb, sb, mode, SC)
                    cq = bytes(alq.raw).replace(b" ", b"").decode()
                    cs = bytes(als.raw).replace(b" ", b"").decode()
                    oq = bytes(eq).replace(b" ", b"").decode()
                    osx = bytes(es).replace(b" ", b"").decode()
                    assert (cq, cs) == (oq, osx), (
                        f"alignment disagreement {name} pair {k}")
                    rec["alignments"][name] = {"q": cq, "s": cs}
            # self-alignment invariant for pair 0 of each class
            if k == 0:
                self_score = getattr(lib, "global_alignment_score")(
                    qb, len(qb), qb, len(qb))
                assert self_score == 2 * len(qb)
                rec["self_global_score"] = int(self_score)
            entry["pairs"].append(rec)
        out["classes"].append(entry)
        print(f"class {cls['minlen']}x{cls['maxlen']}: "
              f"{len(entry['pairs'])} pairs done")

    with open(os.path.join(HERE, "golden.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("wrote golden.json")


if __name__ == "__main__":
    main()
