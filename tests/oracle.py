"""Independent scalar weight oracles (VERDICT round-1 item 5).

Dead-simple per-target Python loops, deliberately sharing NO code with
``mpassit_jax/weights/``:

- bilinear-on-dual: ray/plane intersection + 2-D sub-triangle areas
  (production uses normalized spherical triple products);
- nearest: scalar argmin of great-circle distance (production uses a
  cKDTree over chord distance);
- conservative: textbook Sutherland–Hodgman with Python lists in the
  gnomonic tangent plane (production uses a vectorized padded-array clip
  or the C kernel).

These implement the same documented semantics (DESIGN.md "Method
semantics") through different math, so agreement to ~1e-12 validates the
production *weights*, not just the apply.
"""

import math

import numpy as np


def _xyz(lat_deg, lon_deg):
    la, lo = math.radians(lat_deg), math.radians(lon_deg)
    return np.array([math.cos(la) * math.cos(lo),
                     math.cos(la) * math.sin(lo),
                     math.sin(la)])


def oracle_bilinear_cell(mesh, lat_t, lon_t):
    """Per-target dict {cell_id: weight} via plane-intersection barycentric
    over ALL complete dual triangles (exhaustive containment search)."""
    tris = mesh.complete_triangles()
    out = []
    for lat, lon in zip(np.ravel(lat_t), np.ravel(lon_t)):
        p = _xyz(lat, lon)
        best = None          # (min_bary, {cell: w})
        for (ca, cb, cc) in tris:
            A = _xyz(mesh.lat_cell[ca], mesh.lon_cell[ca])
            B = _xyz(mesh.lat_cell[cb], mesh.lon_cell[cb])
            C = _xyz(mesh.lat_cell[cc], mesh.lon_cell[cc])
            # intersect the ray origin->p with the plane through A, B, C
            nrm = np.cross(B - A, C - A)
            denom = float(np.dot(nrm, p))
            if abs(denom) < 1e-300:
                continue
            t = float(np.dot(nrm, A)) / denom
            if t <= 0:
                continue         # triangle is on the antipodal hemisphere
            q = t * p            # point in the triangle's plane
            # 2-D barycentric via sub-areas (projected on the plane normal)
            area = float(np.dot(nrm, np.cross(B - A, C - A)))
            wa = float(np.dot(nrm, np.cross(B - q, C - q))) / area
            wb = float(np.dot(nrm, np.cross(C - q, A - q))) / area
            wc = float(np.dot(nrm, np.cross(A - q, B - q))) / area
            mn = min(wa, wb, wc)
            if best is None or mn > best[0]:
                best = (mn, {int(ca): wa, int(cb): wb, int(cc): wc})
        if best is None or best[0] < -1e-9:
            out.append({})       # unmapped (quirk Q5)
        else:
            w = {c: max(v, 0.0) for c, v in best[1].items()}
            s = sum(w.values())
            out.append({c: v / s for c, v in w.items()})
    return out


def oracle_nearest(mesh, lat_t, lon_t):
    """Per-target {cell: 1.0} by scalar great-circle argmin."""
    out = []
    for lat, lon in zip(np.ravel(lat_t), np.ravel(lon_t)):
        p = _xyz(lat, lon)
        dists = [math.acos(np.clip(np.dot(p, _xyz(la, lo)), -1, 1))
                 for la, lo in zip(mesh.lat_cell, mesh.lon_cell)]
        out.append({int(np.argmin(dists)): 1.0})
    return out


def _clip_poly(subject, a, b):
    """Sutherland–Hodgman single-edge clip: keep the side left of a->b."""
    def side(p):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])

    out = []
    n = len(subject)
    for i in range(n):
        cur, nxt = subject[i], subject[(i + 1) % n]
        dc, dn = side(cur), side(nxt)
        if dc >= 0:
            out.append(cur)
            if dn < 0:
                t = dc / (dc - dn)
                out.append((cur[0] + t * (nxt[0] - cur[0]),
                            cur[1] + t * (nxt[1] - cur[1])))
        elif dn >= 0:
            t = dc / (dc - dn)
            out.append((cur[0] + t * (nxt[0] - cur[0]),
                        cur[1] + t * (nxt[1] - cur[1])))
    return out


def _area(poly):
    s = 0.0
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        s += x1 * y2 - x2 * y1
    return 0.5 * s


def oracle_conservative(mesh, grid):
    """Per-target {cell: overlap_fraction} by scalar clipping of every
    source Voronoi polygon against the target quad in the gnomonic plane
    tangent at the target center (same geometry contract as production)."""
    lat4, lon4 = grid.corner_quads()
    T = grid.lat.size
    out = []
    for t in range(T):
        j, i = divmod(t, grid.nx)
        nvec = _xyz(grid.lat[j, i], grid.lon[j, i])
        ref = np.array([0.0, 0.0, 1.0]) if abs(nvec[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        e1 = np.cross(ref, nvec)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(nvec, e1)

        def gno(v):
            d = float(np.dot(v, nvec))
            return (float(np.dot(v, e1)) / d, float(np.dot(v, e2)) / d)

        quad = [gno(_xyz(lat4[j, i, k], lon4[j, i, k])) for k in range(4)]
        if _area(quad) < 0:
            quad = quad[::-1]
        qarea = _area(quad)
        row = {}
        for s in range(mesh.ncells):
            verts = [v for v in mesh.vertices_on_cell[s] if v >= 0]
            vxyz = [_xyz(mesh.lat_vertex[v], mesh.lon_vertex[v])
                    for v in verts]
            # gnomonic projection is 2-to-1: far-hemisphere cells (dn <= 0
            # for any vertex) would project as phantom covers on a GLOBAL
            # mesh. A cell genuinely overlapping the (small) target quad
            # has every vertex well inside the near hemisphere.
            if any(float(np.dot(v, nvec)) <= 0.1 for v in vxyz):
                continue
            poly = [gno(v) for v in vxyz]
            if _area(poly) < 0:
                poly = poly[::-1]
            for k in range(4):
                poly = _clip_poly(poly, quad[k], quad[(k + 1) % 4])
                if len(poly) < 3:
                    poly = []
                    break
            frac = _area(poly) / qarea if poly else 0.0
            if frac > 1e-12:
                row[s] = frac
        out.append(row)
    return out


def oracle_bilinear_vertex(mesh, lat_t, lon_t):
    """Node-located bilinear oracle (the vorticity path,
    interp.F90:350-366): containing Voronoi cell = scalar great-circle
    argmin of generators; its corner polygon fan-triangulated from the
    first listed vertex (the documented triangulation choice); weights =
    ray/plane-intersection barycentric in the best-containing fan
    sub-triangle. Shares no code with weights/bilinear.py
    (production: cKDTree + vectorized triple products)."""
    out = []
    for lat, lon in zip(np.ravel(lat_t), np.ravel(lon_t)):
        p = _xyz(lat, lon)
        dists = [math.acos(np.clip(np.dot(p, _xyz(la, lo)), -1, 1))
                 for la, lo in zip(mesh.lat_cell, mesh.lon_cell)]
        cell = int(np.argmin(dists))
        verts = [int(v) for v in mesh.vertices_on_cell[cell] if v >= 0]
        best = None          # (min_bary, {vertex: w})
        for s in range(1, len(verts) - 1):
            va, vb, vc = verts[0], verts[s], verts[s + 1]
            A = _xyz(mesh.lat_vertex[va], mesh.lon_vertex[va])
            B = _xyz(mesh.lat_vertex[vb], mesh.lon_vertex[vb])
            C = _xyz(mesh.lat_vertex[vc], mesh.lon_vertex[vc])
            nrm = np.cross(B - A, C - A)
            denom = float(np.dot(nrm, p))
            if abs(denom) < 1e-300:
                continue
            t = float(np.dot(nrm, A)) / denom
            if t <= 0:
                continue
            q = t * p
            area = float(np.dot(nrm, np.cross(B - A, C - A)))
            wa = float(np.dot(nrm, np.cross(B - q, C - q))) / area
            wb = float(np.dot(nrm, np.cross(C - q, A - q))) / area
            wc = float(np.dot(nrm, np.cross(A - q, B - q))) / area
            mn = min(wa, wb, wc)
            if best is None or mn > best[0]:
                best = (mn, {va: wa, vb: wb, vc: wc})
        if best is None or best[0] < -1e-9:
            out.append({})       # unmapped (quirk Q5)
        else:
            w = {}
            for v, val in best[1].items():
                w[v] = w.get(v, 0.0) + max(val, 0.0)
            s = sum(w.values())
            out.append({v: val / s for v, val in w.items()})
    return out


def _inv_bilinear_quadratic(P00, P10, P01, P11):
    """Closed-form inverse bilinear in the plane, target at the origin:
    solve the quadratic resultant cross2(A+aB, C+aD)=0 for a, back-solve
    b — a different algorithm from production's Newton iteration."""
    A = np.asarray(P00)
    B = np.asarray(P10) - A
    C = np.asarray(P01) - A
    D = np.asarray(P11) - np.asarray(P10) - np.asarray(P01) + A

    def cr(u, v):
        return u[0] * v[1] - u[1] * v[0]

    c2 = cr(B, D)
    c1 = cr(A, D) + cr(B, C)
    c0 = cr(A, C)
    roots = []
    if abs(c2) < 1e-14 * (abs(c1) + abs(c0) + 1e-300):
        if abs(c1) > 1e-300:
            roots = [-c0 / c1]
    else:
        disc = c1 * c1 - 4.0 * c2 * c0
        if disc >= 0.0:
            r = math.sqrt(disc)
            roots = [(-c1 + r) / (2 * c2), (-c1 - r) / (2 * c2)]
    best = None
    for a in roots:
        e = C + a * D            # b*e = -(A + a*B)
        den = float(np.dot(e, e))
        if den < 1e-300:
            continue
        b = -float(np.dot(A + a * B, e)) / den
        viol = max(-a, a - 1.0, -b, b - 1.0, 0.0)
        if best is None or viol < best[0]:
            best = (viol, a, b)
    if best is None:
        return np.inf, 0.5, 0.5
    return best


def oracle_grid_bilinear(src_lat, src_lon, dst_lat, dst_lon, unmapped_mask):
    """Grid->grid spherical-bilinear oracle (the center->EDGE restagger,
    interp.F90:295-328): per destination point, EXHAUSTIVE scalar search
    over all source quads in the gnomonic plane tangent at the point,
    inverse bilinear by the closed-form quadratic (production: structural
    candidate lists + Newton). ``unmapped_mask`` marks the outermost
    staggered column/row that stays unmapped by contract (quirk Q6);
    points whose best containment violation exceeds the documented SLACK
    (1e-2 of a cell) also unmap."""
    SLACK = 1e-2
    ny, nx = src_lat.shape
    sxyz = np.array([[_xyz(src_lat[j, i], src_lon[j, i])
                      for i in range(nx)] for j in range(ny)])
    out = []
    flat_mask = np.ravel(unmapped_mask)
    for t, (lat, lon) in enumerate(zip(np.ravel(dst_lat),
                                       np.ravel(dst_lon))):
        if flat_mask[t]:
            out.append({})
            continue
        p = _xyz(lat, lon)
        ref = np.array([0.0, 0.0, 1.0]) if abs(p[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        e1 = np.cross(ref, p)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(p, e1)

        def gno(v):
            d = float(np.dot(v, p))
            return np.array([float(np.dot(v, e1)) / d,
                             float(np.dot(v, e2)) / d])

        best = None            # (viol, corners, a, b)
        for j in range(ny - 1):
            for i in range(nx - 1):
                if float(np.dot(sxyz[j, i], p)) < 0.5:
                    continue   # far-hemisphere quad
                viol, a, b = _inv_bilinear_quadratic(
                    gno(sxyz[j, i]), gno(sxyz[j, i + 1]),
                    gno(sxyz[j + 1, i]), gno(sxyz[j + 1, i + 1]))
                if best is None or viol < best[0]:
                    best = (viol, (j * nx + i, j * nx + i + 1,
                                   (j + 1) * nx + i, (j + 1) * nx + i + 1),
                            a, b)
        if best is None or best[0] > SLACK:
            out.append({})
            continue
        _, (c00, c10, c01, c11), a, b = best
        a = min(max(a, 0.0), 1.0)
        b = min(max(b, 0.0), 1.0)
        row = {c00: (1 - a) * (1 - b), c10: a * (1 - b),
               c01: (1 - a) * b, c11: a * b}
        out.append({c: v for c, v in row.items() if v != 0.0})
    return out


def ell_to_dicts(ell):
    """Production ELLWeights -> per-target {src: weight} for comparison."""
    T = ell.idx.shape[0] if ell.idx.ndim == 2 else len(ell.idx)
    idx = ell.idx.reshape(T, -1)
    w = ell.w.reshape(T, -1)
    out = []
    for t in range(T):
        row = {}
        for c, v in zip(idx[t], w[t]):
            if v != 0.0:
                row[int(c)] = row.get(int(c), 0.0) + float(v)
        out.append(row)
    return out


def assert_weight_dicts_close(got, want, tol=1e-12):
    """Compare per-target weight dicts over the union of keys (a weight may
    be exactly 0 in one implementation and FP-noise ~1e-17 in the other)."""
    assert len(got) == len(want)
    for t, (g, ww) in enumerate(zip(got, want)):
        for c in set(g) | set(ww):
            assert abs(g.get(c, 0.0) - ww.get(c, 0.0)) <= tol, \
                (t, c, g.get(c, 0.0), ww.get(c, 0.0))
