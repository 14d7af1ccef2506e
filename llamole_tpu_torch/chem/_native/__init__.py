"""ctypes bindings for the chemkit native library.

Builds chemkit.so from chemkit.cpp on first use (g++ -O2, cached next to
the source). Every entry point has a pure-Python fallback, so import
never fails — `available()` reports whether the native path is live.
Set LLAMOLE_NO_NATIVE=1 to force the Python implementations.
"""

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ...utils.logging import get_logger

logger = get_logger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "chemkit.cpp")
_SO = os.path.join(_HERE, "chemkit.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[str]:
    # a per-process name and an atomic rename: concurrent builders (test
    # workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        logger.warning("chemkit native build failed (%s); using Python "
                       "fallbacks", e)
        return None


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LLAMOLE_NO_NATIVE"):
            return None
        so = _SO
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(_SRC)):
            so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            logger.warning("chemkit load failed (%s)", e)
            return None
        lib.ck_wl_ranks.restype = ctypes.c_int32
        lib.ck_wl_ranks.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.ck_morgan_bits.restype = ctypes.c_int32
        lib.ck_morgan_bits.argtypes = [
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.ck_sssr.restype = ctypes.c_int32
        lib.ck_sssr.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p,  # n_atoms, n_bonds, bonds
            i32p, i32p, i32p,                      # CSR off/nbr/bidx
            ctypes.c_int32,                        # target
            i32p, ctypes.c_int32,                  # out_atoms, cap
            i32p, ctypes.c_int32,                  # out_off, max_rings
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ck_canonicalize.restype = ctypes.c_int32
        lib.ck_canonicalize.argtypes = [
            ctypes.c_int32, i32p,                  # n_atoms, atoms (n x 6)
            ctypes.c_int32, i32p,                  # n_bonds, bonds (m x 4)
            i32p, i32p, i32p,                      # CSR off/nbr/bidx
            ctypes.c_int32, ctypes.c_int32,        # do_sanitize, do_write
            i32p, i32p,                            # out_atom_arom, out_bonds
            ctypes.c_char_p, ctypes.c_int32,       # out_smiles, cap
            i32p,                                  # err_info
        ]
        lib.ck_parse_smiles.restype = ctypes.c_int32
        lib.ck_parse_smiles.argtypes = [
            ctypes.c_char_p, ctypes.c_int32,       # text, len
            ctypes.c_int32, ctypes.c_int32,        # do_sanitize, do_write
            i32p, ctypes.c_int32,                  # out_atoms, cap
            i32p, ctypes.c_int32,                  # out_bonds, cap
            i32p,                                  # out_counts [n, m]
            ctypes.c_char_p, ctypes.c_int32,       # out_smiles, cap
            i32p,                                  # err_info
        ]
        lib.ck_apply_template.restype = ctypes.c_int32
        lib.ck_apply_template.argtypes = [
            i32p, ctypes.c_int32,                  # prod blob
            i32p, ctypes.c_int32,                  # tmpl blob
            ctypes.c_int32, ctypes.c_int32,        # max_embeddings/matches
            ctypes.c_int32,                        # max_outcomes
            ctypes.c_char_p, ctypes.c_int32,       # out, cap
        ]
        lib.ck_match_component.restype = ctypes.c_int32
        lib.ck_match_component.argtypes = [
            ctypes.c_int32, i32p,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            i32p, i32p, i32p, i32p, i32p,          # mol CSR adjacency
            ctypes.c_int32, i32p, ctypes.c_int32,  # query program
            ctypes.c_int32, i32p,                  # query bonds
            ctypes.c_int32, i32p,                  # max_matches, out
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        logger.info("chemkit native library loaded")
        return _lib


def available() -> bool:
    return get_lib() is not None


def _mol_edges(mol) -> np.ndarray:
    edges = np.empty((mol.n_bonds(), 3), np.int32)
    for i, b in enumerate(mol.bonds):
        edges[i, 0] = b.a1
        edges[i, 1] = b.a2
        edges[i, 2] = int(round(b.valence_contrib() * 2))
    return np.ascontiguousarray(edges.reshape(-1))


def wl_ranks(mol) -> Optional[list]:
    """Native canonical ranks; None when the library is unavailable."""
    from ..periodic import default_valences

    lib = get_lib()
    if lib is None:
        return None
    n = mol.n_atoms()
    # one pass over bonds for 2x bond-order sums + the edge array
    # (equivalent to per-atom mol.bond_order_sum/total_hs, which walk
    # the adjacency through Python property chains per atom)
    bos2 = [0] * n
    edges = np.empty((mol.n_bonds(), 3), np.int32)
    for i, b in enumerate(mol.bonds):
        c = 3 if b.aromatic else 2 * b.order
        bos2[b.a1] += c
        bos2[b.a2] += c
        edges[i, 0] = b.a1
        edges[i, 1] = b.a2
        edges[i, 2] = c
    inv = np.empty((n, 7), np.int64)
    adj = mol._adj
    for i, a in enumerate(mol.atoms):
        # implicit-H count inline (mol.implicit_hs semantics: explicit
        # wins; else first allowed valence >= ceil(bond order sum))
        if a.explicit_hs is not None:
            th = a.explicit_hs
        elif a.z == 0:
            th = 0
        else:
            allowed = default_valences(a.z, a.charge)
            if allowed is None:
                th = 0
            else:
                ceil_bos = (bos2[i] + 1) // 2
                th = 0
                for v in allowed:
                    if v >= ceil_bos:
                        th = v - ceil_bos
                        break
        inv[i] = (a.z, a.charge, a.isotope, int(a.aromatic),
                  len(adj[i]), th, bos2[i])
    out = np.empty(n, np.int32)
    rc = lib.ck_wl_ranks(n, 7, np.ascontiguousarray(inv.reshape(-1)),
                         mol.n_bonds(), np.ascontiguousarray(edges.reshape(-1)),
                         out)
    if rc != 0:
        return None
    return out.tolist()


def sssr(mol, target: int) -> Optional[list]:
    """Native exact SSSR (minimum cycle basis) — identical ring lists
    to Mol.smallest_rings' Python path. `target` = m - n + c, already
    known > 0 by the caller. None when unavailable / the call fails."""
    lib = get_lib()
    if lib is None:
        return None
    n, m = mol.n_atoms(), mol.n_bonds()
    bonds = np.empty((m, 2), np.int32)
    for i, b in enumerate(mol.bonds):
        bonds[i, 0] = b.a1
        bonds[i, 1] = b.a2
    off = np.empty(n + 1, np.int32)
    nbr = np.empty(2 * m, np.int32)
    bidx = np.empty(2 * m, np.int32)
    e = 0
    for i in range(n):
        off[i] = e
        for w, be in mol._adj[i].items():
            nbr[e] = w
            bidx[e] = be
            e += 1
    off[n] = e
    cap = max(target * n, 1)
    out_atoms = np.empty(cap, np.int32)
    out_off = np.empty(target + 1, np.int32)
    count = ctypes.c_int32(0)
    rc = lib.ck_sssr(n, m, np.ascontiguousarray(bonds.reshape(-1)),
                     off, nbr, bidx, target,
                     out_atoms, cap, out_off, target, ctypes.byref(count))
    if rc != 0:
        return None
    k = count.value
    return [out_atoms[out_off[i]:out_off[i + 1]].tolist() for i in range(k)]


def match_component(mol_ser, query_ser, nq: int,
                    max_matches: int) -> Optional[list]:
    """Native SMARTS component matching over pre-serialized arrays (built
    and cached by chem/smarts.py). Returns [{query_idx: mol_idx}] in the
    exact enumeration order of the Python matcher, or None when the
    library is unavailable / the call fails."""
    lib = get_lib()
    if lib is None:
        return None
    n_atoms, ctx, masks, off, nbr, order, arom, ring = mol_ser
    prog, qbonds, n_qbonds = query_ser
    out = np.empty(max_matches * nq, np.int32)
    count = ctypes.c_int32(0)
    rc = lib.ck_match_component(
        n_atoms, ctx, masks, off, nbr, order, arom, ring,
        nq, prog, len(prog), n_qbonds, qbonds,
        max_matches, out, ctypes.byref(count))
    if rc != 0:
        return None
    k = count.value
    return [dict(enumerate(out[i * nq:(i + 1) * nq].tolist()))
            for i in range(k)]


def canonicalize(mol, sanitize: bool = True, write: bool = True,
                 apply_flags: bool = True):
    """Fused native sanitize + canonical SMILES write (ck_canonicalize).

    Handles tetrahedral parity and double-bond cis/trans natively
    (bit-identical port of the stereo writer incl. the automorphic
    tie-break enumeration — tests/test_native_canonicalize.py fuzzes
    both). Only extended stereo classes (Atom.ext_stereo) return None;
    those molecules use the Python reference path (chem/extstereo.py).

    Returns:
      None                        native unavailable / unsupported input
      ("ok", smiles_or_None)      success (smiles None when write=False)
      ("kekulize", None)          kekulization failed (raise SmilesError)
      ("valence", (idx, total2))  valence error at atom idx, 2x valence
    """
    lib = get_lib()
    if lib is None:
        return None
    n, m = mol.n_atoms(), mol.n_bonds()
    if n == 0:
        return None
    arows = []
    for a in mol.atoms:
        if a.ext_stereo is not None:
            return None
        arows.append((a.z, a.charge, a.isotope,
                      -1 if a.explicit_hs is None else a.explicit_hs,
                      a.aromatic, a.atom_map, a.parity))
    brows = [(0, 0, 0, 0, 0, -1, -1)] if m == 0 else []
    for b in mol.bonds:
        stereo = 0
        sx = sy = -1
        if b.stereo is not None and b.stereo_atoms is not None:
            stereo = 2 if b.stereo == "trans" else 1
            sx, sy = b.stereo_atoms
        brows.append((b.a1, b.a2, b.order, b.aromatic, stereo, sx, sy))
    offl = [0] * (n + 1)
    nbrl = []
    bidxl = []
    e = 0
    for i in range(n):
        offl[i] = e
        adj = mol._adj[i]
        nbrl.extend(adj.keys())
        bidxl.extend(adj.values())
        e += len(adj)
    offl[n] = e
    try:
        atoms = np.asarray(arows, np.int32)
        bonds = np.asarray(brows, np.int32)
    except (OverflowError, ValueError):
        return None  # field beyond int32 (huge atom map): Python path
    off = np.asarray(offl, np.int32)
    nbr = np.asarray(nbrl if nbrl else [0], np.int32)
    bidx = np.asarray(bidxl if bidxl else [0], np.int32)
    out_arom = np.empty(n, np.int32)
    out_bonds = np.empty((max(m, 1), 2), np.int32)
    cap = 64 + 24 * n + 12 * m
    buf = ctypes.create_string_buffer(cap)
    err = np.zeros(2, np.int32)
    rc = lib.ck_canonicalize(
        n, np.ascontiguousarray(atoms.reshape(-1)),
        m, np.ascontiguousarray(bonds.reshape(-1)),
        off, nbr, bidx,
        int(sanitize), int(write),
        out_arom, np.ascontiguousarray(out_bonds.reshape(-1)),
        buf, cap, err)
    if rc == 1:
        return ("kekulize", None)
    if rc == 2:
        return ("valence", (int(err[0]), int(err[1])))
    if rc != 0:
        return None
    if sanitize and apply_flags:
        for i, a in enumerate(mol.atoms):
            # bit 0: aromatic; upper bits: ehs+1 (0 = None) — carries
            # the perception pin of non-carbon aromatic H counts
            v = int(out_arom[i])
            a.aromatic = bool(v & 1)
            ehs = (v >> 1) - 1
            if ehs >= 0:
                a.explicit_hs = ehs
        for i, b in enumerate(mol.bonds):
            b.order = int(out_bonds[i, 0])
            b.aromatic = bool(out_bonds[i, 1])
            # sanitize_mol stereo clearing (smiles.py:816-819) mirrored
            # onto the caller's Mol
            if b.stereo is not None and (b.aromatic or b.order != 2):
                b.stereo = None
                b.stereo_atoms = None
        mol._smarts_ctx_cache = None
        mol._native_match_cache = None
    return ("ok", buf.value.decode() if write else None)


def parse(text, sanitize: bool = True, write: bool = False,
          want_mol: bool = True):
    """Fused native SMILES parse + optional sanitize + canonical write
    (ck_parse_smiles). Tetrahedral chirality (@/@@/@TH1/@TH2) and
    directional bonds (/ \\) are handled natively (bit-identical stereo
    port — tests/test_native_canonicalize.py fuzzes both paths);
    extended stereo classes (@AL/@SP/@TB/@OH and the bare-@ shorthands
    on 2-/5-/6-coordinate centers) and parse errors fall back to the
    Python parser — chem/smiles.py stays the reference implementation
    and the error-message authority.

    Returns:
      None                          native unavailable / fall back
      ("ok", atoms, bonds, smiles)  atoms: list of n [z, charge, isotope,
                                    ehs(-1=None), aromatic, map, parity];
                                    bonds: list of m [a1, a2, order,
                                    aromatic, stereo(0 none/1 cis/
                                    2 trans), sx, sy] (both None when
                                    want_mol=False); smiles None when
                                    write=False
      ("kekulize", ...) / ("valence", ...)  sanitize-stage rejection
                                    (trusted: these stages are the same
                                    bit-ported code sanitize_mol uses)
    """
    lib = get_lib()
    if lib is None or not isinstance(text, str) or not text:
        return None
    try:
        raw = text.encode("utf-8")
    except UnicodeEncodeError:
        return None
    cap = len(raw) + 1
    out_atoms = np.empty(cap * 7, np.int32) if want_mol else _NULL_I32
    out_bonds = np.empty(cap * 7, np.int32) if want_mol else _NULL_I32
    counts = np.zeros(2, np.int32)
    scap = 64 + 36 * cap if write else 1
    buf = ctypes.create_string_buffer(scap)
    err = np.zeros(2, np.int32)
    rc = lib.ck_parse_smiles(
        raw, len(raw), int(sanitize), int(write),
        out_atoms, cap if want_mol else 0,
        out_bonds, cap if want_mol else 0,
        counts, buf, scap, err)
    if rc not in (0, 1, 2):
        return None  # parse error / unsupported / caps: Python path
    n, m = int(counts[0]), int(counts[1])
    atoms = bonds = None
    if want_mol:
        atoms = out_atoms[:n * 7].reshape(n, 7).tolist()
        bonds = out_bonds[:m * 7].reshape(m, 7).tolist()
    if rc == 1:
        return ("kekulize", None, atoms, bonds)
    if rc == 2:
        return ("valence", (int(err[0]), int(err[1])), atoms, bonds)
    return ("ok", atoms, bonds, buf.value.decode() if write else None)


_NULL_I32 = np.empty(1, np.int32)  # placeholder for unused out pointers


def apply_template(prod_blob: np.ndarray, tmpl_blob: np.ndarray,
                   max_embeddings: int, max_matches: int,
                   max_outcomes: int):
    """One native retro-template application (ck_apply_template).

    Returns a tuple of outcome strings, or None when the native path
    cannot decide (library unavailable / internal cap) — the caller runs
    the Python reference path (chem/reaction.py) instead."""
    lib = get_lib()
    if lib is None:
        return None
    n = int(prod_blob[0])
    cap = 16 + max_outcomes * (80 + 24 * (n + len(tmpl_blob)))
    buf = ctypes.create_string_buffer(cap)
    rc = lib.ck_apply_template(
        prod_blob, len(prod_blob), tmpl_blob, len(tmpl_blob),
        max_embeddings, max_matches, max_outcomes, buf, cap)
    if rc < 0:
        return None
    if rc == 0:
        return ()
    return tuple(buf.value.decode().split("\n"))


def morgan_bits(mol, radius: int, n_bits: int) -> Optional[np.ndarray]:
    """Native Morgan bit vector; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = mol.n_atoms()
    ring = mol.ring_membership()
    inv = np.empty((n, 7), np.int64)
    for i, a in enumerate(mol.atoms):
        inv[i] = (a.z, a.charge + 16, mol.degree(i), mol.total_hs(i),
                  int(round(mol.bond_order_sum(i) * 2)), int(ring[i]),
                  int(a.aromatic))
    out = np.zeros(n_bits, np.uint8)
    rc = lib.ck_morgan_bits(n, np.ascontiguousarray(inv.reshape(-1)),
                            mol.n_bonds(), _mol_edges(mol),
                            radius, n_bits, out)
    if rc != 0:
        return None
    return out.astype(bool)
