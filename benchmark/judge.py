"""The comparisons that decide ``correct``, and the numbers they print.

A codec cell's sample of decoded batches is held against the reference
(:mod:`benchmark.reference.codec`), computed from the same images and
weights:

* ``pixels_off``: the share of the decoded images' uint8 values that differ
  from the reference's decode of its own symbols;
* ``z_off``: the share of z symbols, read back from the blobs' z strings
  with the reference's own tables and range decoder, that differ from the
  reference's z symbols of the image;
* ``y_rate_gap``: how far the blobs' y streams, in bits, lie from what the
  reference's y symbols cost in the blob's format against the reference's
  own y tables at the rows its sigma picks (each symbol its row's
  ``-log2`` frequency, an escape its payload too, and each stream's flush:
  the rANS lanes' from the stream's first words, or the range coder's
  mean), over the latter. A family that codes y in S slices has S
  streams a blob, summed. It holds the hyper-synthesis's sigma,
  the scale indexes and the coder's efficiency, which a round trip alone
  does not: encoder and decoder take the same rows.

A training cell's first three steps are held against the reference's three
steps from the same parameters, batches and noise
(:func:`training_numbers`): each step's loss, and the first gradient and
the parameters' change over the three steps by the median leaf
(``grad_gap_median``, ``change_gap_median``). Their worst leaves
(``grad_gap``, ``change_gap``) are printed beside them: they swing from
seed to seed, a hyper transform's kernel reading 10-100 times the other
seeds' on a few of them, where a float32 ReLU or bound kink of the hyper
path falls one way in the program and the other in the reference.
Each number is compared with the limit the workload file sets for it; the
other numbers are printed beside them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.harness import Check
from benchmark.reference import entropy
from benchmark.reference.codec import ReferenceCodec
from benchmark.reference.formats import blob_fields


def y_words(blob: bytes, streams: int) -> int:
    """The 16-bit words of a device-coded blob's ``streams`` y streams."""
    return sum(len(f) // 2 for f in blob_fields(blob, streams)[0])


def rans_flush_bits(stream: bytes, lanes: int) -> float:
    """The K-lane rANS format's fixed cost in a stream: each lane starts at
    2^16 and ends flushing its 32-bit state, which the stream's first 2K
    words hold (high word first), so it adds 48 bits less the log2 of that
    state."""
    words = np.frombuffer(stream, np.uint16)[: 2 * lanes].astype(np.float64)
    if len(words) < 2 * lanes:
        return 0.0
    states = words[0::2] * 65536.0 + words[1::2]
    return float(np.sum(48.0 - np.log2(np.maximum(states, 1.0))))


# The range coder's fixed cost a stream: its leading byte and four flush
# bytes, less the four bits on average that its last range still holds.
RANGE_FLUSH_BITS = 36.0


def y_format(blob: bytes, streams: int):
    """(the blob's ``streams`` y streams in bits, their escape payload, their
    fixed bits): each stream pays its own flush, from its first 2K words
    where rANS coded it, else the range coder's."""
    ys, _z, _zshape, K = blob_fields(blob, streams)
    bits = sum(8 * len(f) for f in ys)
    if K is not None:  # device-coded: K-lane rANS
        return bits, entropy.rans_escape_bits, sum(rans_flush_bits(f, K) for f in ys)
    return bits, entropy.range_escape_bits, RANGE_FLUSH_BITS * len(ys)


def y_rate(ref: ReferenceCodec, exp, blobs) -> Tuple[float, float]:
    """(bits the blobs' y streams hold, bits the reference expects)."""
    coded = expected = 0.0
    for i, blob in enumerate(blobs):
        bits, escape_bits, fixed = y_format(blob, ref.streams)
        coded += bits
        expected += ref.y_bits(exp, i, escape_bits) + fixed
    return coded, expected


def codec_numbers(decoded, z_decoded, ref_images, ref_z) -> Dict[str, float]:
    a = np.asarray(decoded, np.int16)
    b = np.asarray(ref_images, np.int16)
    diff = np.abs(a - b)
    z_a = np.asarray(z_decoded)
    z_b = np.asarray(ref_z)
    return {"pixels_off": float(np.mean(diff > 0)),
            "pixels_off_2": float(np.mean(diff > 1)),
            "pixels_max_diff": float(diff.max()),
            "z_off": float(np.mean(z_a != z_b)) if z_a.shape == z_b.shape else 1.0}


def _checks(numbers: Dict[str, float], workload: dict) -> List[Check]:
    return [Check(name, numbers[name], float(limit))
            for name, limit in workload["correct"]["limits"].items()]


@torch.no_grad()
def codec(cfg: dict, params: dict, device, items, workload: dict) -> Tuple[List[Check], List[str]]:
    """Checks of a codec cell's sample ``items`` of (images, blobs,
    decoded images)."""
    if not items:  # nothing came back to judge: every share reads as all off
        return _checks(dict.fromkeys(workload["correct"]["limits"], 1.0), workload), [
            "no decoded batch to judge"]
    ref = ReferenceCodec(cfg, params, device)
    images = np.concatenate([it[0] for it in items])
    decoded = np.concatenate([it[2] for it in items])
    blobs = [b for it in items for b in it[1]]
    exp = ref.expected(images)
    z_decoded = np.stack([ref.z_from_blob(b) for b in blobs])
    numbers = codec_numbers(decoded, z_decoded, exp.images.cpu().numpy(),
                            exp.z_symbols.cpu().numpy())
    coded, expected = y_rate(ref, exp, blobs)
    numbers["y_rate_gap"] = abs(coded - expected) / expected if expected > 0 else 1.0
    y = exp.y_symbols
    notes = [
        f"judged {len(images)} images: " + ", ".join(f"{k} {v:.6g}" for k, v in numbers.items()),
        f"y: {y.numel()} symbols, |symbol| up to {int(y.abs().max())}, "
        f"{100 * ref.escape_share(exp):.4f}% outside their table (escapes); coded in "
        f"{coded:.0f} bits, the reference's tables give {expected:.0f} "
        f"({coded / max(expected, 1.0):.6f}x)",
    ]
    return _checks(numbers, workload), notes


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or the median leaf's, whichever is
    larger; for the leaves ``keep`` names."""
    ref_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference.items()}
    median = float(np.median([ref_norms[k] for k in keep]))
    return {k: abs(float(torch.linalg.vector_norm(program[k].double())) - ref_norms[k])
            / max(ref_norms[k], median) for k in keep}


def training_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], List[str]]:
    """``prog`` and ``ref`` hold ``losses`` (a list), ``grads`` (the first
    step's, by leaf), ``change`` (the parameters after the steps minus
    before, by leaf). Leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone under Adam and are left
    out of both leaf numbers."""
    g_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grads"].items()}
    median = float(np.median(list(g_norms.values())))
    keep = [k for k, n in g_norms.items() if n >= 1e-3 * median]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not math.isfinite(loss_gap):
        loss_gap = 1.0
    grads = leaf_gaps(prog["grads"], ref["grads"], keep)
    changes = leaf_gaps(prog["change"], ref["change"], keep)
    grad_leaf = max(grads, key=grads.get)
    change_leaf = max(changes, key=changes.get)
    numbers = {"loss_gap": loss_gap,
               "grad_gap_median": float(np.median(list(grads.values()))),
               "change_gap_median": float(np.median(list(changes.values()))),
               "grad_gap": grads[grad_leaf], "change_gap": changes[change_leaf]}
    notes = [f"losses {prog['losses']} against {ref['losses']}",
             f"leaves compared {len(keep)} of {len(g_norms)} (left out: "
             f"{sorted(set(g_norms) - set(keep))}); worst gradient leaf {grad_leaf}, "
             f"worst change leaf {change_leaf}"]
    return numbers, notes


def window_numbers(prog: dict, ref: dict) -> Tuple[Dict[str, float], str]:
    """One window step taken by the program and by the reference from the
    same state: ``window_loss_gap``, the relative gap of its loss, and
    ``window_change_gap_median``, the median leaf's gap of the parameters'
    change (leaves as in :func:`training_numbers`, by the reference's
    gradient of that step). The worst leaf's gap is printed beside them."""
    g_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grads"].items()}
    median = float(np.median(list(g_norms.values())))
    keep = [k for k, n in g_norms.items() if n >= 1e-3 * median]
    a, b = prog["losses"][0], ref["losses"][0]
    loss_gap = abs(a - b) / abs(b)
    if not math.isfinite(loss_gap):
        loss_gap = 1.0
    changes = leaf_gaps(prog["change"], ref["change"], keep)
    worst = max(changes, key=changes.get)
    numbers = {"window_loss_gap": loss_gap,
               "window_change_gap_median": float(np.median(list(changes.values()))),
               "window_change_gap": changes[worst]}
    return numbers, (f"loss {a} against {b}; leaves compared {len(keep)} of {len(g_norms)}; "
                     f"worst change leaf {worst}")


def training(numbers: Dict[str, float], workload: dict) -> List[Check]:
    return _checks(numbers, workload)
