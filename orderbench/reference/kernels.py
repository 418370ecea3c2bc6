"""Plain NumPy definitions of the three device steps an ordering runs.

Each function takes one call's inputs as the program packed them (host
arrays) and returns what the call has to return, lane by lane:

* ``bfs``: each lane's distance from its sources, up to ``width`` hops,
  ``UNREACH`` beyond;
* ``match``: each lane's randomized heavy-edge matching, ``rounds``
  rounds of coin flips, proposals to the heaviest unmatched acceptor and
  grants to the heaviest proposal;
* ``fm``: each lane's vertex-separator Fiduccia-Mattheyses passes, one
  move at a time, each pass reverting to its best feasible state.

They are written from the algorithms, one lane and one step at a time,
and share no code with the program.  Every float sum is over
integer-valued float32 weights, so the results are exact and the
comparison with the program is bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from orderbench.reference import threefry

UNREACH = 2 ** 30
BIG_NOISE = np.float32(1e9)
SMALL_NOISE = np.float32(1e-3)
_NEG_INF = np.float32(-np.inf)


def bfs(nbr: np.ndarray, src: np.ndarray, width: int) -> np.ndarray:
    """nbr (L, n, d) int32 ids (-1 pads), src (L, n) nonzero at sources →
    (L, n) int32 hop distances, ``UNREACH`` beyond ``width``."""
    L, n, _ = nbr.shape
    out = np.full((L, n), UNREACH, dtype=np.int32)
    for lane in range(L):
        rows = nbr[lane]
        dist = out[lane]
        frontier = np.flatnonzero(src[lane] != 0)
        dist[frontier] = 0
        for hop in range(1, width + 1):
            if not len(frontier):
                break
            reach = rows[frontier].ravel()
            reach = np.unique(reach[reach >= 0])
            reach = reach[dist[reach] == UNREACH]
            dist[reach] = hop
            frontier = reach
    return out


def _lane_key(keys: np.ndarray, lane: int) -> np.ndarray:
    return (np.asarray(keys[lane], dtype=np.int64) & 0xFFFFFFFF).astype(
        np.uint32)


def match(nbr: np.ndarray, wgt: np.ndarray, keys: np.ndarray,
          rounds: int) -> np.ndarray:
    """nbr, wgt (L, n, d) int32, keys (L, 2) → (L, n) int32 mates (self
    for a vertex left single).  ``n`` and ``d`` are the call's padded
    shape, on which the draws depend."""
    L, n, d = nbr.shape
    out = np.empty((L, n), dtype=np.int32)
    vid = np.arange(n, dtype=np.int64)
    for lane in range(L):
        ids, w = nbr[lane].astype(np.int64), wgt[lane]
        valid = (ids >= 0) & (ids < n)
        safe = np.where(valid, ids, 0)
        mate = np.full(n, -1, dtype=np.int64)
        round_keys = threefry.split(_lane_key(keys, lane), rounds)
        for r in range(rounds):
            k_coin, k_tie, k_grant = threefry.split(round_keys[r], 3)
            single = mate < 0
            proposer = threefry.bernoulli(k_coin, 0.5, (n,)) & single
            acceptor = ~proposer & single
            ok = valid & acceptor[safe]
            score = np.where(ok, w.astype(np.float32)
                             + threefry.uniform(k_tie, (n, d)), _NEG_INF)
            slot = score.argmax(axis=1)                  # first maximum
            target = np.where(proposer & ok.any(axis=1),
                              safe[vid, slot], -1)
            gkey = w[vid, slot].astype(np.float32) + \
                threefry.uniform(k_grant, (n,))
            # each acceptor grants its heaviest proposal, ties to the
            # smaller proposer id
            props = np.flatnonzero(target >= 0)
            order = np.lexsort((props, -gkey[props], target[props]))
            props = props[order]
            first = np.ones(len(props), dtype=bool)
            first[1:] = target[props[1:]] != target[props[:-1]]
            won = props[first]
            mate[won] = target[won]
            mate[target[won]] = won
        out[lane] = np.where(mate < 0, vid, mate)
    return out


def _fm_lane(rows: np.ndarray, vw: np.ndarray, part: np.ndarray,
             locked: np.ndarray, noise: np.ndarray, eps_abs: np.float32,
             max_moves: int, n_pert: int, passes: int, pos_only: bool
             ) -> Tuple[np.ndarray, np.float32, np.float32]:
    """One lane: rows (n, d) ids, vw (n,) float32, part (n,) in {0, 1, 2}
    (2 = separator), noise (passes, 2, n) float32."""
    n = rows.shape[0]
    adj = [r[r >= 0] for r in rows]                  # each row's slots

    def weights(p):
        return (vw[p == 0].sum(dtype=np.float32),
                vw[p == 1].sum(dtype=np.float32),
                vw[p == 2].sum(dtype=np.float32))

    w0, w1, ws = weights(part)
    best, best_ws, best_imb = part.copy(), ws, np.abs(w0 - w1)
    for p in range(passes):
        part = best.copy()
        w0, w1, ws = weights(part)
        # pulled_s[v]: the weight that v's move to side s pulls into the
        # separator (its neighbours on the other side), once per slot
        pulled = [np.zeros(n, dtype=np.float32) for _ in range(2)]
        for v in range(n):
            side = part[adj[v]]
            pulled[0][v] = vw[adj[v]][side == 1].sum(dtype=np.float32)
            pulled[1][v] = vw[adj[v]][side == 0].sum(dtype=np.float32)
        moved = np.zeros(n, dtype=bool)
        step, alive = 0, True
        while step < max_moves and alive:
            thr = max(eps_abs, np.abs(w0 - w1))
            free = (part == 2) & ~moved & ~locked
            amp = BIG_NOISE if step < (n_pert if p == 0 else 0) \
                else SMALL_NOISE
            scores = []
            for s in (0, 1):
                if s == 0:
                    diff = (w0 + vw) - (w1 - pulled[0])
                else:
                    diff = (w0 - pulled[1]) - (w1 + vw)
                gain = vw - pulled[s]
                ok = free & (np.abs(diff) <= thr)
                if pos_only:
                    ok &= gain > 0
                scores.append(np.where(ok, gain + noise[p, s] * amp,
                                       _NEG_INF))
            flat = np.concatenate(scores)
            idx = int(flat.argmax())                 # the first maximum
            alive = bool(flat[idx] > _NEG_INF)
            dv = pulled_w = np.float32(0.0)
            side = 0
            if alive:
                side, v = divmod(idx, n)
                slots = adj[v]
                pulled_x = slots[part[slots] == 1 - side]
                pulled_w = vw[pulled_x].sum(dtype=np.float32)
                part[pulled_x] = 2
                part[v] = side
                dv = vw[v]
                # v joins `side`: its neighbours' pull toward it grows
                np.add.at(pulled[1 - side], slots, dv)
                # each pulled x leaves side 1 - s: its neighbours' pull
                # toward s shrinks
                for x in pulled_x:
                    np.add.at(pulled[side], adj[x], -vw[x])
                moved[v] = True
            if side == 0:
                w0, w1 = w0 + dv, w1 - pulled_w
            else:
                w0, w1 = w0 - pulled_w, w1 + dv
            ws = ws - dv + pulled_w
            imb = np.abs(w0 - w1)
            if ws < best_ws and imb <= max(eps_abs, best_imb):
                best, best_ws = part.copy(), ws
                best_imb = min(imb, best_imb)
            step += 1
    return best, best_ws, best_imb


def fm_noise(k: np.ndarray, n: int, passes: int) -> np.ndarray:
    """(passes, 2, n) float32: per pass, split the key, keep the first
    half and draw ``uniform((2, n))`` from the second."""
    out = []
    for _ in range(passes):
        k, sub = threefry.split(k, 2)
        out.append(threefry.uniform(sub, (2, n)))
    return np.stack(out)


def fm(nbr: np.ndarray, lane_work: np.ndarray, vwgt: np.ndarray,
       parts: np.ndarray, locked: np.ndarray, keys: np.ndarray,
       eps_frac: np.ndarray, max_moves: np.ndarray, n_pert: np.ndarray,
       passes: int, pos_only: bool, lanes=None):
    """One FM call: tiles nbr (W, n, d) with lane_work (L,), vwgt (L, n),
    parts (L, n), locked (L, n), keys (L, 2), eps_frac, max_moves, n_pert
    (L,).  The balance slack is ``eps_frac · Σ vwgt`` in float32.  Returns
    (parts int8, sep_w float32, imb float32) of the ``lanes`` asked for
    (all by default), each (len(lanes), ...)."""
    W, n, d = nbr.shape
    lanes = range(len(lane_work)) if lanes is None else lanes
    empty = np.full((n, d), -1, dtype=nbr.dtype)
    out_p, out_w, out_i = [], [], []
    for lane in lanes:
        tile = int(lane_work[lane])
        rows = nbr[tile] if 0 <= tile < W else empty
        vw = vwgt[lane].astype(np.float32)
        eps_abs = np.float32(eps_frac[lane]) * vw.sum(dtype=np.float32)
        noise = fm_noise(_lane_key(keys, lane), n, passes)
        p, w, i = _fm_lane(rows, vw, parts[lane].astype(np.int8),
                           locked[lane].astype(bool), noise, eps_abs,
                           int(max_moves[lane]), int(n_pert[lane]), passes,
                           pos_only)
        out_p.append(p)
        out_w.append(w)
        out_i.append(i)
    return (np.stack(out_p).astype(np.int8),
            np.array(out_w, dtype=np.float32),
            np.array(out_i, dtype=np.float32))
