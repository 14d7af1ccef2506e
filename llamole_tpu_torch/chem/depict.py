"""First-party 2D molecule depiction -> SVG.

The reference renders molecules and per-step reactions with RDKit's
drawing stack (launch.py:175-187 Draw.MolToImage / reaction images);
RDKit is not available here, so this module provides the equivalent:
a ring-template + tree-expansion coordinate layout and a small SVG
renderer for molecules and reactions.

Layout: SSSR rings are placed as regular polygons (fused rings unfold
around the shared edge, spiro rings rotate away from the shared atom);
acyclic branches grow outward with 120-degree zigzag angles, fanning at
junctions. Quality target is "readable structure diagram", not RDKit's
depiction parity.

A copy of llamole_tpu/chem/depict.py over this package's chem/mol.py and
chem/smiles.py; tests/test_torch_hostlayers.py holds its layouts and SVG
text equal to the JAX package's, byte for byte. The float arithmetic of
layout_2d is kept in the same order so the SVG text stays equal.
"""

import cmath
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .mol import H_SLOT, Mol, PARITY_CCW
from .smiles import parse_smiles

Vec = complex


def _assign_wedges(mol: Mol, coords: List[Tuple[float, float]]
                   ) -> Dict[Tuple[int, int], int]:
    """Wedge/hash marks for tetrahedral centers: {(center, nbr): +1 =
    solid wedge (neighbor toward the viewer) / -1 = hashed (away)}.

    The reference gets wedges from RDKit's WedgeMolBonds inside
    Draw.MolToImage (launch.py:175-187); here the direction is derived
    from the stored parity and the 2D layout: give the chosen neighbor
    a +/-1 out-of-plane coordinate (the implicit H, when present, takes
    the opposite perturbation — tetrahedral bond vectors sum to ~0) and
    pick the sign whose 3D handedness over the INTERNAL reference order
    ([H?, neighbors ascending], mol.py Atom.parity) matches.

    Frame: layout coordinates are rendered with y increasing DOWN the
    SVG (mol_to_svg applies no flip), i.e. the viewer sees a mirrored
    right-handed frame — with z pointing out of the screen toward the
    viewer, '@' (CCW from the first internal slot) corresponds to a
    POSITIVE row determinant. Anchor: first slot at z=+1 (toward the
    viewer), remaining three anticlockwise ON SCREEN.
    """
    out: Dict[Tuple[int, int], int] = {}
    ring_bond = mol.ring_bond_membership()
    for v in range(mol.n_atoms()):
        a = mol.atoms[v]
        if not a.parity:
            continue
        nbrs = mol.neighbors(v)
        if len(nbrs) not in (3, 4):
            continue
        # wedge-bond choice: plain single bonds only, prefer acyclic,
        # then terminal neighbors, then achiral ends; lowest index ties
        cands = []
        for w in nbrs:
            b = mol.bond_between(v, w)
            if b.order != 1 or b.aromatic:
                continue
            if (w, v) in out:
                continue  # already wedged from the other center
            cands.append((ring_bond[mol._adj[v][w]],
                          mol.degree(w) > 1,
                          mol.atoms[w].parity != 0, w))
        if not cands:
            continue
        w = min(cands)[3]

        cx, cy = coords[v]
        internal: List = ([H_SLOT] if len(nbrs) == 3 else []) + sorted(nbrs)

        def pos(key, s):
            if key == H_SLOT:
                # opposite the in-plane neighbor sum, z opposing the wedge
                dx = sum(coords[n][0] - cx for n in nbrs)
                dy = sum(coords[n][1] - cy for n in nbrs)
                return (cx - dx, cy - dy, -float(s))
            z = float(s) if key == w else 0.0
            return (coords[key][0], coords[key][1], z)

        def det(s):
            p1, p2, p3, p4 = (pos(k, s) for k in internal)
            ax, ay, az = (p2[i] - p1[i] for i in range(3))
            bx, by, bz = (p3[i] - p1[i] for i in range(3))
            cx_, cy_, cz = (p4[i] - p1[i] for i in range(3))
            return (ax * (by * cz - bz * cy_)
                    - ay * (bx * cz - bz * cx_)
                    + az * (bx * cy_ - by * cx_))

        want_pos = a.parity == PARITY_CCW  # '@': det > 0 (see docstring)
        d = det(+1)
        if abs(d) < 1e-9:
            continue  # degenerate layout: no reliable wedge
        out[(v, w)] = 1 if (d > 0) == want_pos else -1
    return out


def layout_2d(mol: Mol) -> List[Tuple[float, float]]:
    """Coordinates (bond length 1.0) for every atom."""
    n = mol.n_atoms()
    if n == 0:
        return []
    pos: Dict[int, Vec] = {}
    rings = [r for r in mol.smallest_rings()]
    ring_of_atom: Dict[int, List[int]] = {}
    for ri, r in enumerate(rings):
        for a in r:
            ring_of_atom.setdefault(a, []).append(ri)
    placed_rings = set()

    def place_polygon(ring: List[int], fixed: List[int]) -> None:
        """Place `ring` as a regular polygon; atoms in `fixed` keep their
        existing coordinates (0, 1 or 2 of them)."""
        k = len(ring)
        r_circ = 0.5 / math.sin(math.pi / k)
        if len(fixed) >= 2:
            # unfold around the fixed edge: centroid on the free side
            a, b = fixed[0], fixed[1]
            pa, pb = pos[a], pos[b]
            mid = (pa + pb) / 2
            edge = pb - pa
            if abs(edge) < 1e-9:
                edge = 1.0
            normal = edge / abs(edge) * 1j
            apo = math.sqrt(max(r_circ ** 2 - 0.25, 0.01))
            # choose the side away from already-placed neighbor mass
            others = [pos[x] for x in pos
                      if x not in (a, b) and abs(pos[x] - mid) < 3.0]
            side = mid + normal * apo
            if others:
                avg = sum(others) / len(others)
                if abs(side - avg) < abs(mid - normal * apo - avg):
                    normal = -normal
            center = mid + normal * apo
            # order ring starting at a, heading to b
            ia = ring.index(a)
            seq = ring[ia:] + ring[:ia]
            if len(seq) > 1 and seq[1] != b:
                seq = [seq[0]] + list(reversed(seq[1:]))
            ang0 = cmath.phase(pa - center)
            ang1 = cmath.phase(pb - center)
            # step direction that walks a -> b
            step = (ang1 - ang0) % (2 * math.pi)
            if abs(step - 2 * math.pi / k) > abs(step - 2 * math.pi + 2 * math.pi / k):
                dstep = -2 * math.pi / k
            else:
                dstep = 2 * math.pi / k
            for j, atom in enumerate(seq):
                if atom not in pos:
                    pos[atom] = center + cmath.rect(r_circ, ang0 + dstep * j)
        elif len(fixed) == 1:
            a = fixed[0]
            pa = pos[a]
            anchors = [pos[w] for w in mol.neighbors(a) if w in pos]
            if anchors:
                away = pa - sum(anchors) / len(anchors)
                direction = away / abs(away) if abs(away) > 1e-9 else 1.0
            else:
                direction = 1.0
            center = pa + direction * r_circ
            ia = ring.index(a)
            seq = ring[ia:] + ring[:ia]
            ang0 = cmath.phase(pa - center)
            for j, atom in enumerate(seq):
                if atom not in pos:
                    pos[atom] = center + cmath.rect(
                        r_circ, ang0 + 2 * math.pi * j / k)
        else:
            center = 0j
            for j, atom in enumerate(ring):
                pos[atom] = center + cmath.rect(
                    r_circ, math.pi / 2 + 2 * math.pi * j / k)

    def place_ring_system(start_ring: int) -> None:
        """Place start_ring and everything fused to it transitively."""
        queue = [start_ring]
        while queue:
            ri = queue.pop(0)
            if ri in placed_rings:
                continue
            ring = rings[ri]
            fixed = [a for a in ring if a in pos]
            place_polygon(ring, fixed)
            placed_rings.add(ri)
            for a in ring:
                for rj in ring_of_atom.get(a, []):
                    if rj not in placed_rings and rj not in queue:
                        queue.append(rj)

    def expand_from(a: int) -> List[int]:
        """Place unplaced neighbors of atom a; returns newly placed."""
        new = []
        unplaced = [w for w in mol.neighbors(a) if w not in pos]
        if not unplaced:
            return new
        anchors = [pos[w] for w in mol.neighbors(a) if w in pos]
        if anchors:
            away = pos[a] - sum(anchors) / len(anchors)
            base = cmath.phase(away) if abs(away) > 1e-9 else 0.0
        else:
            base = math.pi / 6  # lone start: zigzag baseline
        spread = math.pi / 3
        k = len(unplaced)
        angles = ([base] if k == 1 else
                  [base + spread * (j - (k - 1) / 2) for j in range(k)])
        for w, ang in zip(unplaced, angles):
            if w in ring_of_atom and all(
                    ri not in placed_rings for ri in ring_of_atom[w]):
                # entering a new ring system through atom w
                pos[w] = pos[a] + cmath.rect(1.0, ang)
                place_ring_system(ring_of_atom[w][0])
                new.extend(x for x in rings[ring_of_atom[w][0]])
            elif w not in pos:
                pos[w] = pos[a] + cmath.rect(1.0, ang)
            new.append(w)
        return new

    for frag in mol.fragments():
        if any(a in pos for a in frag):
            continue
        # fragment offset: right of everything placed so far
        if pos:
            x_max = max(p.real for p in pos.values()) + 2.5
        else:
            x_max = 0.0
        start = None
        for a in frag:
            if a in ring_of_atom:
                start = a
                break
        if start is not None:
            place_ring_system(ring_of_atom[start][0])
        else:
            pos[frag[0]] = 0j
        # translate the seed so fragments don't overlap
        seed_atoms = [a for a in frag if a in pos]
        if seed_atoms and x_max:
            x_min = min(pos[a].real for a in seed_atoms)
            for a in seed_atoms:
                pos[a] += (x_max - x_min)
        # BFS expansion over the fragment
        queue = list(seed_atoms)
        seen = set(queue)
        while queue:
            a = queue.pop(0)
            for w in expand_from(a):
                if w not in seen:
                    seen.add(w)
                    queue.append(w)
        # anything missed (pathological): drop at fragment centroid
        for a in frag:
            if a not in pos:
                pts = [pos[x] for x in frag if x in pos]
                c = sum(pts) / len(pts) if pts else 0j
                pos[a] = c + 0.5

    return [(pos[i].real, pos[i].imag) for i in range(n)]


# ---------------------------------------------------------------------------
# SVG rendering
# ---------------------------------------------------------------------------

_ATOM_COLOR = {"N": "#2040d0", "O": "#d02020", "S": "#b0a000",
               "F": "#20a020", "Cl": "#20a020", "Br": "#a05020",
               "I": "#802080", "P": "#d07000"}


def _atom_label(mol: Mol, idx: int) -> Optional[str]:
    a = mol.atoms[idx]
    sym = a.symbol
    if sym == "C" and a.charge == 0 and a.isotope == 0 and mol.degree(idx) > 0:
        return None  # skeletal carbon
    hs = mol.total_hs(idx)
    label = sym
    if hs == 1:
        label += "H"
    elif hs > 1:
        label += f"H{hs}"
    if a.charge == 1:
        label += "+"
    elif a.charge == -1:
        label += "-"
    elif a.charge:
        label += f"{a.charge:+d}"
    return label


def mol_to_svg(mol_or_smiles, width: int = 320, height: int = 240,
               standalone: bool = True) -> Optional[str]:
    """Render a Mol (or SMILES string) as an SVG snippet; None when the
    SMILES does not parse (mirrors launch.py:175-181 returning no image
    for invalid molecules)."""
    if isinstance(mol_or_smiles, str):
        try:
            mol = parse_smiles(mol_or_smiles, sanitize=True)
        except Exception:
            return None
    else:
        mol = mol_or_smiles
    coords = layout_2d(mol)
    if not coords:
        return None
    xs = [c[0] for c in coords]
    ys = [c[1] for c in coords]
    pad = 0.8
    x0, x1 = min(xs) - pad, max(xs) + pad
    y0, y1 = min(ys) - pad, max(ys) + pad
    scale = min(width / (x1 - x0), height / (y1 - y0), 42.0)
    ox = (width - (x1 - x0) * scale) / 2 - x0 * scale
    oy = (height - (y1 - y0) * scale) / 2 - y0 * scale

    def pt(i):
        return (coords[i][0] * scale + ox, coords[i][1] * scale + oy)

    labels = {i: _atom_label(mol, i) for i in range(mol.n_atoms())}
    wedges = _assign_wedges(mol, coords)
    # ring centroids for aromatic inner-bond offset direction
    ring_centroid: Dict[int, complex] = {}
    for r in mol.smallest_rings():
        c = sum(complex(*pt(a)) for a in r) / len(r)
        for j, v in enumerate(r):
            w = r[(j + 1) % len(r)]
            bi = mol._adj[v].get(w)
            if bi is not None:
                ring_centroid[bi] = c

    parts = []
    for bi, b in enumerate(mol.bonds):
        p1, p2 = complex(*pt(b.a1)), complex(*pt(b.a2))
        d = p2 - p1
        if abs(d) < 1e-6:
            continue
        u = d / abs(d)
        # shorten toward labeled atoms so lines don't strike text
        if labels[b.a1]:
            p1 += u * 7
        if labels[b.a2]:
            p2 -= u * 7
        off = u * 1j * 3.2

        def line(a, c, dash=""):
            parts.append(
                f'<line x1="{a.real:.1f}" y1="{a.imag:.1f}" '
                f'x2="{c.real:.1f}" y2="{c.imag:.1f}" '
                f'stroke="#202020" stroke-width="1.6"{dash}/>')

        wedge = wedges.get((b.a1, b.a2))
        wfrom, wto = p1, p2
        if wedge is None:
            wedge = wedges.get((b.a2, b.a1))
            wfrom, wto = p2, p1

        def wedge_marks(narrow, wide, kind):
            """Solid wedge (filled triangle, kind=+1) or hashed wedge
            (perpendicular rungs widening outward, kind=-1), narrow at
            the stereocenter (RDKit drawing convention)."""
            wd = wide - narrow
            if abs(wd) < 1e-6:
                return
            perp = wd / abs(wd) * 1j * 3.0
            if kind > 0:
                parts.append(
                    f'<polygon points="{narrow.real:.1f},{narrow.imag:.1f} '
                    f'{(wide + perp).real:.1f},{(wide + perp).imag:.1f} '
                    f'{(wide - perp).real:.1f},{(wide - perp).imag:.1f}" '
                    f'fill="#202020"/>')
            else:
                n_r = max(int(abs(wd) / 4.5), 3)
                for t in range(1, n_r + 1):
                    f = t / n_r
                    c = narrow + wd * f
                    line(c + perp * f, c - perp * f)

        if b.aromatic:
            line(p1, p2)
            centroid = ring_centroid.get(bi)
            if centroid is not None:
                toward = centroid - (p1 + p2) / 2
                sgn = 1 if (toward.real * off.real + toward.imag * off.imag) > 0 else -1
                line(p1 * 0.85 + p2 * 0.15 + off * sgn,
                     p1 * 0.15 + p2 * 0.85 + off * sgn,
                     ' stroke-dasharray="4,2"')
        elif b.order == 1:
            if wedge is not None:
                wedge_marks(wfrom, wto, wedge)
            else:
                line(p1, p2)
        elif b.order == 2:
            line(p1 + off / 2, p2 + off / 2)
            line(p1 - off / 2, p2 - off / 2)
        else:
            line(p1, p2)
            line(p1 + off, p2 + off)
            line(p1 - off, p2 - off)

    for i, label in labels.items():
        if not label:
            continue
        x, y = pt(i)
        color = _ATOM_COLOR.get(mol.atoms[i].symbol, "#202020")
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="9" fill="white"/>'
            f'<text x="{x:.1f}" y="{y + 4:.1f}" text-anchor="middle" '
            f'font-family="Helvetica,sans-serif" font-size="12" '
            f'fill="{color}">{label}</text>')

    body = "".join(parts)
    if not standalone:
        return body
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{height}" viewBox="0 0 {width} {height}">'
            f'<rect width="100%" height="100%" fill="white"/>{body}</svg>')


def reaction_to_svg(product_smiles: str, reactant_smiles: Sequence[str],
                    width_per_mol: int = 240, height: int = 200
                    ) -> Optional[str]:
    """product <- reactants with an arrow, one SVG (reference renders
    per-step reaction images, launch.py:183-187)."""
    mols = [product_smiles] + list(reactant_smiles)
    rendered = []
    for s in mols:
        svg = mol_to_svg(s, width=width_per_mol, height=height,
                         standalone=False)
        if svg is None:
            return None
        rendered.append(svg)

    arrow_w = 60
    plus_w = 24
    total_w = width_per_mol * len(mols) + arrow_w + plus_w * max(
        0, len(reactant_smiles) - 1)
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{total_w}" '
             f'height="{height}" viewBox="0 0 {total_w} {height}">'
             f'<rect width="100%" height="100%" fill="white"/>']
    x = 0.0
    parts.append(f'<g transform="translate({x},0)">{rendered[0]}</g>')
    x += width_per_mol
    mid = height / 2
    parts.append(
        f'<line x1="{x + 10}" y1="{mid}" x2="{x + arrow_w - 14}" y2="{mid}" '
        f'stroke="#202020" stroke-width="1.6"/>'
        f'<polygon points="{x + arrow_w - 14},{mid - 5} '
        f'{x + arrow_w - 4},{mid} {x + arrow_w - 14},{mid + 5}" '
        f'fill="#202020"/>')
    x += arrow_w
    for j, svg in enumerate(rendered[1:]):
        if j:
            parts.append(
                f'<text x="{x + plus_w / 2:.1f}" y="{mid + 5:.1f}" '
                f'text-anchor="middle" font-size="18" '
                f'font-family="Helvetica,sans-serif">+</text>')
            x += plus_w
        parts.append(f'<g transform="translate({x:.1f},0)">{svg}</g>')
        x += width_per_mol
    parts.append("</svg>")
    return "".join(parts)
