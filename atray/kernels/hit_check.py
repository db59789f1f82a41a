"""Checks of the hit kernel: results against a reference with stated
ties, and how often a program calls the kernel.

Used by the CPU tests (kernel interpreted) and by ``chip_smoke.py`` (kernel
compiled for the GPU), so both hold the hit kernel to the same rule:

- where both sides hit, t agrees within ``rtol``;
- the face ids agree, unless the two faces are a *t-tie*: the ray meets
  both at distances within ``rtol * t`` of each other (a shared edge or
  coincident faces), where any winner is a correct nearest hit;
- hit and miss agree, unless the ray grazes the found face within ``rtol``
  of one of its edges in barycentric terms (an *edge tie*: a last-bit
  difference in the edge test decides it).

The kernel's math is f32 elementwise with no dot product, so TF32 never
enters; ties come only from FMA contraction and summation order moving the
last bits. Ties are counted and returned; anything else raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from jax.extend import core as jex_core

MISS_T = 1.0e30


def _candidate(o, d, p0, e1, e2):
    """(t, u, v) of each ray against its own triangle, in float64."""
    pv = np.cross(d, e2)
    det = np.sum(e1 * pv, axis=1)
    inv = np.where(np.abs(det) > 0.0, 1.0 / np.where(det == 0.0, 1.0, det),
                   0.0)
    tv = o - p0
    u = np.sum(tv * pv, axis=1) * inv
    qv = np.cross(tv, e1)
    v = np.sum(d * qv, axis=1) * inv
    t = np.sum(e2 * qv, axis=1) * inv
    return t, u, v


def compare_hits(t_got, id_got, t_ref, id_ref, orig, dirn, p0, e1, e2,
                 rtol: float = 1.0e-5) -> Dict[str, int]:
    """Check (t_got, id_got) against (t_ref, id_ref) for rays (orig, dirn)
    over faces given as (T, 3) arrays p0, e1, e2 (scene face order).

    Returns counts {rays, hits, id_ties, edge_ties}; raises AssertionError
    naming the first offending ray otherwise.
    """
    t_got = np.asarray(t_got, np.float64)
    t_ref = np.asarray(t_ref, np.float64)
    id_got = np.asarray(id_got)
    id_ref = np.asarray(id_ref)
    o = np.asarray(orig, np.float64)
    d = np.asarray(dirn, np.float64)
    p0 = np.asarray(p0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)

    hit_g = id_got >= 0
    hit_r = id_ref >= 0
    assert np.array_equal(hit_g, t_got < MISS_T), "id and t disagree (got)"
    assert np.array_equal(hit_r, t_ref < MISS_T), "id and t disagree (ref)"

    # hit vs miss: only an edge graze may differ
    odd = np.nonzero(hit_g != hit_r)[0]
    edge_ties = 0
    if odd.size:
        f = np.where(hit_g[odd], id_got[odd], id_ref[odd])
        _, u, v = _candidate(o[odd], d[odd], p0[f], e1[f], e2[f])
        margin = np.min(np.abs(np.stack([u, v, 1.0 - u - v])), axis=0)
        bad = margin > rtol
        if bad.any():
            i = odd[np.argmax(bad)]
            raise AssertionError(
                f"ray {i}: hit/miss differ away from an edge "
                f"(got id {id_got[i]} t {t_got[i]}, "
                f"ref id {id_ref[i]} t {t_ref[i]})")
        edge_ties = int(odd.size)

    both = np.nonzero(hit_g & hit_r)[0]
    tg, tr = t_got[both], t_ref[both]
    bad_t = np.abs(tg - tr) > rtol * np.abs(tr)
    if bad_t.any():
        i = both[np.argmax(bad_t)]
        raise AssertionError(
            f"ray {i}: t {t_got[i]} vs reference {t_ref[i]} "
            f"(ids {id_got[i]} / {id_ref[i]})")

    diff = both[id_got[both] != id_ref[both]]
    id_ties = 0
    if diff.size:
        fa, fb = id_got[diff], id_ref[diff]
        ta, _, _ = _candidate(o[diff], d[diff], p0[fa], e1[fa], e2[fa])
        tb, _, _ = _candidate(o[diff], d[diff], p0[fb], e1[fb], e2[fb])
        bad = np.abs(ta - tb) > rtol * np.abs(tb)
        if bad.any():
            i = diff[np.argmax(bad)]
            raise AssertionError(
                f"ray {i}: faces {id_got[i]} / {id_ref[i]} are not a t-tie")
        id_ties = int(diff.size)

    return {"rays": int(id_got.shape[0]), "hits": int(hit_r.sum()),
            "id_ties": id_ties, "edge_ties": edge_ties}


def count_hit_kernels(jaxpr) -> int:
    """Number of ``bvh_hit`` kernel calls in a jaxpr (a ``ClosedJaxpr`` or
    ``Jaxpr``), through every sub-jaxpr: scan and loop bodies, remat, jit.
    A scan body counts once however many iterations it runs."""
    if isinstance(jaxpr, jex_core.ClosedJaxpr):
        jaxpr = jaxpr.jaxpr
    n = 0
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "pallas_call"
                and eqn.params.get("name") == "bvh_hit"):
            n += 1
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                if isinstance(sub, (jex_core.ClosedJaxpr, jex_core.Jaxpr)):
                    n += count_hit_kernels(sub)
    return n
