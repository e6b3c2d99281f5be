"""Host-side generation helpers (``paddle_tpu/generation.py``): the beam
bookkeeping step that the decode session's beam groups call.  The
dense ``SequenceGenerator`` comes with v1 generation (ROADMAP Queue 1
item 4).
"""

from __future__ import annotations

import numpy as np


def beam_select(probs, scores, alive, seqs, eos_id: int, k: int):
    """One host-side beam-search bookkeeping step, the JAX package's
    verbatim (the log floor, the argpartition tie-breaking and the
    dead-beam pool merge included), so the two stay bit-identical.

    ``probs`` (k, V) next-token distributions; ``scores``/``alive``/
    ``seqs`` the beam state.  Returns ``None`` when no beam is alive
    (caller breaks), else ``(scores, seqs, alive, rows, tokens)`` where
    ``rows[j]`` is the parent beam index entry ``j`` continues from and
    ``tokens[j]`` the word it just appended."""
    logp = np.log(np.maximum(probs, 1e-20))
    # dead beams only extend with a frozen no-op
    total = np.where(alive[:, None], scores[:, None] + logp, -np.inf)
    flat = total.ravel()
    V = probs.shape[1]
    n_alive = int(alive.sum())
    if n_alive == 0:
        return None
    top = np.argpartition(-flat, min(k, flat.size - 1))[:k]
    top = top[np.argsort(-flat[top])]
    keep_rows = []
    new_seqs, new_scores, new_alive, new_tokens = [], [], [], []
    dead = [(scores[i], seqs[i]) for i in range(k) if not alive[i]]
    for t in top:
        r, w = divmod(int(t), V)
        if not np.isfinite(flat[t]):
            continue
        keep_rows.append(r)
        new_seqs.append(seqs[r] + [w])
        new_scores.append(flat[t])
        new_alive.append(w != eos_id)
        new_tokens.append(w)
    # pad back to k beams
    while len(keep_rows) < k:
        keep_rows.append(0)
        new_seqs.append(seqs[0])
        new_scores.append(-np.inf)
        new_alive.append(False)
        new_tokens.append(eos_id)
    # finished beams compete with still-alive ones; keep the best k of
    # (new + previously dead)
    pool = list(zip(new_scores, new_seqs, new_alive, keep_rows,
                    new_tokens)) + [
        (s, q, False, 0, eos_id) for s, q in dead]
    pool.sort(key=lambda e: -e[0])
    pool = pool[:k]
    return (np.array([e[0] for e in pool], np.float32),
            [e[1] for e in pool],
            np.array([e[2] for e in pool], bool),
            [e[3] for e in pool],
            [e[4] for e in pool])
