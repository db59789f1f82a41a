"""CPU reference renderer (numpy) — the correctness oracle.

Plays the role the reference's brute-force ``#else`` path plays for its KD
tree (renderer.cpp:58-81, SURVEY.md §4): an independent implementation the
device renderer must match ``allclose``. Pure numpy (no JAX), brute force
over all primitives, same shading conventions as
atray/render/wavefront.py (documented there), consuming explicit
pre-drawn uniforms so stochastic paths are bit-comparable.

Gradient convention: ``finite_diff_grad`` below differentiates the oracle
numerically. Because primitive *selection* is frozen per evaluation only by
the underlying geometry (visibility is detached in the JAX renderer), finite
differencing must use steps small enough not to flip any nearest-hit
decision; tests choose scenes/steps accordingly.
"""

from __future__ import annotations

import numpy as np

INF = 3.0e38
T_MIN = 1.0e-4
EPS = 1.0e-12

PRIM_NONE, PRIM_TRI, PRIM_SPHERE, PRIM_PLANE = 0, 1, 2, 3


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v):
    n = np.sqrt(np.maximum(_dot(v, v), 1.0e-20))
    return v / n[..., None]


def scene_to_numpy(scene):
    """Pull a jnp Scene into plain numpy arrays."""
    return dict(
        vertices=np.asarray(scene.mesh.vertices, np.float32),
        faces=np.asarray(scene.mesh.faces),
        normals=np.asarray(scene.mesh.normals, np.float32),
        face_normal_idx=np.asarray(scene.mesh.face_normal_idx),
        sph_c=np.asarray(scene.spheres.centers, np.float32),
        sph_r=np.asarray(scene.spheres.radii, np.float32),
        sph_m=np.asarray(scene.spheres.material_id),
        pln_n=np.asarray(scene.planes.normals, np.float32),
        pln_o=np.asarray(scene.planes.offsets, np.float32),
        pln_m=np.asarray(scene.planes.material_id),
        tri_m=np.asarray(scene.mesh.material_id),
        emission=np.asarray(scene.materials.emission, np.float32),
        albedo=np.asarray(scene.materials.albedo, np.float32),
        scatter=np.asarray(scene.materials.scatter, np.float32),
        tex_coords=np.asarray(scene.mesh.tex_coords, np.float32),
        face_tex_idx=np.asarray(scene.mesh.face_tex_idx),
        texture=(None if scene.texture is None
                 else np.asarray(scene.texture, np.float32)),
    )


def _tri_intersect_all(orig, dirn, sc):
    """Culled Möller–Trumbore, rays (R,3) x all tris. Returns t,u,v (R,T)."""
    v, f = sc["vertices"], sc["faces"]
    if f.shape[0] == 0:
        r = orig.shape[0]
        return np.full((r, 0), INF), None, None
    p0 = v[f[:, 0]][None]            # (1,T,3)
    e1 = (v[f[:, 1]] - v[f[:, 0]])[None]
    e2 = (v[f[:, 2]] - v[f[:, 0]])[None]
    o = orig[:, None, :]
    d = dirn[:, None, :]
    pvec = np.cross(d, e2)
    det = _dot(e1, pvec)
    valid = det > EPS
    inv = np.where(valid, 1.0 / np.where(valid, det, 1.0), 0.0)
    tvec = o - p0
    u = _dot(tvec, pvec) * inv
    qvec = np.cross(tvec, e1)
    vv = _dot(d, qvec) * inv
    t = _dot(e2, qvec) * inv
    hit = valid & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (t > T_MIN)
    return np.where(hit, t, INF), u, vv


def nearest_hit(orig, dirn, sc):
    """Returns dict of t, prim_type, prim_id, u, v, normal, mat (R,)."""
    r = orig.shape[0]
    best_t = np.full(r, INF, np.float32)
    ptype = np.zeros(r, np.int32)
    pid = np.full(r, -1, np.int32)
    uu = np.zeros(r, np.float32)
    vv = np.zeros(r, np.float32)

    t_all, u_all, v_all = _tri_intersect_all(orig, dirn, sc)
    if t_all.shape[1] > 0:
        tid = np.argmin(t_all, axis=1)
        rr = np.arange(r)
        t = t_all[rr, tid]
        m = t < best_t
        best_t = np.where(m, t, best_t)
        ptype = np.where(m, PRIM_TRI, ptype)
        pid = np.where(m, tid, pid)
        uu = np.where(m, u_all[rr, tid], uu)
        vv = np.where(m, v_all[rr, tid], vv)

    if sc["sph_c"].shape[0] > 0:
        oc = orig[:, None, :] - sc["sph_c"][None]
        b = _dot(oc, dirn[:, None, :])
        c = _dot(oc, oc) - (sc["sph_r"] ** 2)[None]
        disc = b * b - c
        ok = disc > 0
        sq = np.sqrt(np.maximum(disc, 0))
        t0, t1 = -b - sq, -b + sq
        t = np.where(t0 > T_MIN, t0, t1)
        t = np.where(ok & (t > T_MIN), t, INF)
        sid = np.argmin(t, axis=1)
        rr = np.arange(r)
        ts = t[rr, sid]
        m = ts < best_t
        best_t = np.where(m, ts, best_t)
        ptype = np.where(m, PRIM_SPHERE, ptype)
        pid = np.where(m, sid, pid)

    if sc["pln_n"].shape[0] > 0:
        denom = _dot(dirn[:, None, :], sc["pln_n"][None])
        num = sc["pln_o"][None] - _dot(orig[:, None, :], sc["pln_n"][None])
        ok = np.abs(denom) > EPS
        t = np.where(ok, num / np.where(ok, denom, 1.0), INF)
        t = np.where(t > T_MIN, t, INF)
        plid = np.argmin(t, axis=1)
        rr = np.arange(r)
        ts = t[rr, plid]
        m = ts < best_t
        best_t = np.where(m, ts, best_t)
        ptype = np.where(m, PRIM_PLANE, ptype)
        pid = np.where(m, plid, pid)

    # resolve normal & material
    normal = np.zeros((r, 3), np.float32)
    mat = np.zeros(r, np.int32)

    tri_sel = ptype == PRIM_TRI
    if tri_sel.any():
        f = sc["faces"][np.clip(pid, 0, sc["faces"].shape[0] - 1)]
        v = sc["vertices"]
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        flat = _normalize(np.cross(p1 - p0, p2 - p0))
        nidx = sc["face_normal_idx"][np.clip(pid, 0, sc["faces"].shape[0] - 1)]
        has_sm = nidx[:, 0] >= 0
        ncl = np.clip(nidx, 0, sc["normals"].shape[0] - 1)
        n0, n1, n2 = (sc["normals"][ncl[:, k]] for k in range(3))
        w0 = (1.0 - uu - vv)[:, None]
        sm = _normalize(w0 * n0 + uu[:, None] * n1 + vv[:, None] * n2)
        trin = np.where(has_sm[:, None], sm, flat)
        normal = np.where(tri_sel[:, None], trin, normal)
        mat = np.where(tri_sel, sc["tri_m"][np.clip(pid, 0, len(sc["tri_m"]) - 1)], mat)

    sph_sel = ptype == PRIM_SPHERE
    if sph_sel.any():
        c = sc["sph_c"][np.clip(pid, 0, len(sc["sph_r"]) - 1)]
        p = orig + best_t[:, None] * dirn
        normal = np.where(sph_sel[:, None], _normalize(p - c), normal)
        mat = np.where(sph_sel, sc["sph_m"][np.clip(pid, 0, len(sc["sph_m"]) - 1)], mat)

    pln_sel = ptype == PRIM_PLANE
    if pln_sel.any():
        normal = np.where(
            pln_sel[:, None], sc["pln_n"][np.clip(pid, 0, len(sc["pln_o"]) - 1)], normal
        )
        mat = np.where(pln_sel, sc["pln_m"][np.clip(pid, 0, len(sc["pln_m"]) - 1)], mat)

    return dict(t=best_t, ptype=ptype, pid=pid, u=uu, v=vv, normal=normal, mat=mat)


def trace(orig, dirn, sc, bounces, uniforms, nee=False):
    """Path-trace (R,3) radiance; ``uniforms`` is (B, R, 3) in [-1, 1]
    (or (B, R, 6) with ``nee=True``: 3 jitter + light pick + 2 sphere
    point — the NEE convention documented in render/wavefront.py)."""
    r = orig.shape[0]
    o = orig.astype(np.float32).copy()
    d = dirn.astype(np.float32).copy()
    weight = np.ones((r, 3), np.float32)
    color = np.zeros((r, 3), np.float32)
    alive = np.ones(r, bool)
    em, al, scat = sc["emission"], sc["albedo"], sc["scatter"]
    # emissive-triangle area lights (round 5) join the NEE light set
    tri_lights = np.flatnonzero(
        em.max(axis=1)[sc["tri_m"]] > 0.0
    ) if sc["faces"].shape[0] > 0 else np.zeros((0,), np.int64)
    nee_active = nee and (
        sc["sph_c"].shape[0] > 0 or tri_lights.size > 0
    )
    for b in range(bounces):
        h = nearest_hit(o, d, sc)
        hit = h["ptype"] != PRIM_NONE
        miss_now = alive & ~hit
        color += np.where(miss_now[:, None], weight * em[0][None], 0.0)

        live = alive & hit
        n = h["normal"]
        cos_in = _dot(-d, n)
        backface = cos_in < 0
        n_o = np.where(backface[:, None], -n, n)
        atten = np.where(backface, 0.0, cos_in)

        m = h["mat"]
        al_m = al[m]
        if sc.get("texture") is not None and sc["faces"].shape[0] > 0:
            tri_sel = h["ptype"] == PRIM_TRI
            fcl = np.clip(h["pid"], 0, sc["faces"].shape[0] - 1)
            ft = sc["face_tex_idx"][fcl]
            has_uv = ft[:, 0] >= 0
            tcl = np.clip(ft, 0, sc["tex_coords"].shape[0] - 1)
            tc = sc["tex_coords"]
            w0 = 1.0 - h["u"] - h["v"]
            ut = (w0 * tc[tcl[:, 0], 0] + h["u"] * tc[tcl[:, 1], 0]
                  + h["v"] * tc[tcl[:, 2], 0])
            vt = (w0 * tc[tcl[:, 0], 1] + h["u"] * tc[tcl[:, 1], 1]
                  + h["v"] * tc[tcl[:, 2], 1])
            tex = sc["texture"]
            th, tw = tex.shape[0], tex.shape[1]
            ix = np.clip((np.mod(ut, 1.0) * tw).astype(np.int32), 0, tw - 1)
            iy = np.clip(((1.0 - np.mod(vt, 1.0)) * th).astype(np.int32),
                         0, th - 1)
            texel = tex.reshape(-1, 3)[iy * tw + ix]
            use = (tri_sel & has_uv)[:, None]
            al_m = np.where(use, al_m * texel, al_m)
        if (not nee_active) or b == 0:
            color += np.where(live[:, None], weight * em[m], 0.0)

        if nee_active:
            t_safe0 = np.where(hit, h["t"], 0.0).astype(np.float32)
            hp0 = o + t_safe0[:, None] * d
            ns = sc["sph_c"].shape[0]
            nt = tri_lights.size
            NL = ns + nt
            uni = uniforms[b]
            u_pick = (uni[:, 3] + 1.0) * 0.5
            lid = np.minimum((u_pick * NL).astype(np.int32), NL - 1)
            is_tri_l = lid >= ns
            target = np.zeros((r, 3), np.float32)
            lem = np.zeros((r, 3), np.float32)
            lr = np.zeros((r,), np.float32)
            sph_lid = np.full((r,), -1, np.int32)
            if ns > 0:
                slid = np.clip(lid, 0, ns - 1)
                lc = sc["sph_c"][slid]
                lr = sc["sph_r"][slid].astype(np.float32)
                lem = em[sc["sph_m"][slid]]
                z = uni[:, 4]
                phi = (uni[:, 5] + 1.0) * np.pi
                s = np.sqrt(np.maximum(1.0 - z * z, 0.0))
                spt = np.stack(
                    [s * np.cos(phi), s * np.sin(phi), z], axis=1)
                target = (lc + lr[:, None] * spt).astype(np.float32)
                sph_lid = slid
            cos_lt = np.zeros((r,), np.float32)
            area = np.zeros((r,), np.float32)
            if nt > 0:
                v = sc["vertices"]
                fl = sc["faces"][tri_lights]
                p0_l = v[fl[:, 0]]
                e1_l = v[fl[:, 1]] - p0_l
                e2_l = v[fl[:, 2]] - p0_l
                cr_l = np.cross(e1_l, e2_l)
                len_l = np.sqrt(np.maximum((cr_l * cr_l).sum(1), 1e-20))
                nrm_l = cr_l / len_l[:, None]
                area_l = 0.5 * len_l
                em_l = em[sc["tri_m"][tri_lights]]
                tlid = np.clip(lid - ns, 0, nt - 1)
                r1 = (uni[:, 4] + 1.0) * 0.5
                r2 = (uni[:, 5] + 1.0) * 0.5
                su = np.sqrt(np.maximum(r1, 0.0))
                b1 = (su * (1.0 - r2))[:, None]
                b2 = (su * r2)[:, None]
                pt = p0_l[tlid] + b1 * e1_l[tlid] + b2 * e2_l[tlid]
                target = np.where(is_tri_l[:, None],
                                  pt.astype(np.float32), target)
                lem = np.where(is_tri_l[:, None], em_l[tlid], lem)
                sph_lid = np.where(is_tri_l, -1, sph_lid)
            delta = target - hp0
            dist = np.sqrt(np.maximum(_dot(delta, delta), 1.0e-12))
            ldir = delta / dist[:, None]
            cos_l = np.maximum(_dot(n_o, ldir), 0.0)
            so = np.where(live[:, None], hp0, 1.0e7).astype(np.float32)
            sd = np.where(live[:, None], ldir, np.array([0, 0, 1.0])).astype(np.float32)
            sh = nearest_hit(so, sd, sc)
            is_light = (sh["ptype"] == PRIM_SPHERE) & (sh["pid"] == sph_lid)
            occluded = (sh["t"] < dist - 1.0e-3) & (~is_light)
            geom = (lr * lr) / np.maximum(dist * dist, lr * lr)
            gain = cos_l * geom * NL
            if nt > 0:
                cos_lt = np.abs(_dot(nrm_l[tlid], ldir))
                gain_t = (cos_l * cos_lt * area_l[tlid]
                          / np.maximum(dist * dist, 1e-12) * NL)
                gain = np.where(is_tri_l, gain_t, gain)
            direct = weight * al_m * lem * gain[:, None]
            color += np.where((live & ~occluded)[:, None], direct, 0.0)

        weight = np.where(live[:, None], weight * al_m * atten[:, None], weight)

        random_bounce = _normalize(n_o + uniforms[b][:, 0:3])
        pure_bounce = _normalize(d - 2.0 * _dot(d, n_o)[:, None] * n_o)
        # NB: jnp reflect() doesn't normalize; mirror of unit d about unit n
        # is already unit, so normalizing here is a no-op up to rounding.
        new_d = _normalize(
            random_bounce + (pure_bounce - random_bounce) * scat[m][:, None]
        )
        t_safe = np.where(hit, h["t"], 0.0).astype(np.float32)
        hp = o + t_safe[:, None] * d
        o = np.where(live[:, None], hp, o)
        d = np.where(live[:, None], new_d, d)
        alive = live
    return color


def render_film(scene, orig, dirn, bounces, uniforms, spp, h, w, nee=False):
    sc = scene_to_numpy(scene)
    color = trace(
        np.asarray(orig), np.asarray(dirn), sc, bounces, np.asarray(uniforms),
        nee=nee,
    )
    film = color.reshape(spp, h, w, 3).mean(axis=0)
    return np.clip(film, 0.0, 1.0)
