"""Kabsch-Sander secondary-structure assignment (DSSP-equivalent, in numpy).

Replaces the external ``mkdssp`` binary + Bio.PDB wrapper used by the reference
(deeprank2/features/secondary_structure.py:105). Implements the parts of DSSP
that matter for the 3-class (helix/strand/coil) feature:

- backbone H-bond energies E = 0.084 * 332 * (1/r_ON + 1/r_CH - 1/r_OH - 1/r_CN)
  with the amide H placed from the previous residue's C=O direction; a bond is
  E < -0.5 kcal/mol;
- n-turns (n = 3, 4, 5) and minimal helices (G/H/I from two consecutive turns);
- parallel/antiparallel bridges -> strand (B/E);
- turns (T) and bends (S, kappa > 70 deg); everything else coil.

Assignment priority follows DSSP: H > B/E > G > I > T > S.
"""

from __future__ import annotations

import numpy as np

HBOND_ENERGY_CUTOFF = -0.5
CHAIN_BREAK_DISTANCE = 2.5
Q1Q2_F = 0.084 * 332.0


def _backbone_table(arrays) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray]:
    """Residues with a full backbone: (residue indices, {N,CA,C,O} coords, chain ids)."""
    first = first_atom_per_residue(arrays, ("N", "CA", "C", "O"))
    ok = np.all([first[nm] >= 0 for nm in ("N", "CA", "C", "O")], axis=0)
    res_ids = np.flatnonzero(ok)
    coords = {nm: arrays.positions[first[nm][res_ids]].astype(np.float64).reshape(-1, 3) for nm in ("N", "CA", "C", "O")}
    return res_ids, coords, np.asarray(arrays.res_chain)[res_ids].astype(np.int64)


def first_atom_per_residue(arrays, names: tuple[str, ...]) -> dict[str, np.ndarray]:
    """For each atom name, the first matching atom index per residue (-1 = none)."""
    atom_names = np.asarray(arrays.atom_names)
    atom_res = np.asarray(arrays.atom_residue)
    out = {}
    for nm in names:
        sel = np.flatnonzero(atom_names == nm)
        first = np.full(arrays.num_residues, -1, dtype=np.int64)
        # reversed assignment leaves the FIRST occurrence per residue
        first[atom_res[sel][::-1]] = sel[::-1]
        out[nm] = first
    return out


def assign_secondary_structure(arrays) -> dict[int, str]:
    """DSSP letter per residue index ('H','G','I','E','B','T','S',' ')."""
    res_ids, bb, chains = _backbone_table(arrays)
    n = len(res_ids)
    if n == 0:
        return {}

    # sequence continuity: i and i+1 are connected if same chain and peptide bond intact
    connected = np.zeros(n, dtype=bool)  # connected[i] == residue i bonded to i+1
    if n > 1:
        dist_cn = np.linalg.norm(bb["C"][:-1] - bb["N"][1:], axis=1)
        connected[:-1] = (chains[:-1] == chains[1:]) & (dist_cn < CHAIN_BREAK_DISTANCE)

    def chain_connected(i: int, j: int) -> bool:
        """All peptide bonds intact between positions i..j (i < j)."""
        return bool(connected[i:j].all())

    # amide H from previous residue C=O; none for chain starts and prolines
    h_pos = np.full((n, 3), np.nan)
    is_pro = np.array([arrays.res_aa_ids[r] >= 0 and _is_proline(arrays, r) for r in res_ids])
    if n > 1:
        co = bb["C"][:-1] - bb["O"][:-1]
        co_norm = np.linalg.norm(co, axis=1)
        ok = connected[:-1] & ~is_pro[1:] & (co_norm > 0)
        h_pos[1:][ok] = bb["N"][1:][ok] + co[ok] / co_norm[ok, None]

    # H-bond energies donor NH(i) ... acceptor CO(j), sparse over candidate
    # pairs: DSSP's own prefilter — a bonding pair's CA atoms lie within 9 A
    # (minimal CA distance test in the original implementation) — shrinks the
    # O(n^2) x 4 distance matrices to O(n x k) on the neighbor list.
    has_h = ~np.isnan(h_pos[:, 0])
    hbond = np.zeros((n, n), dtype=bool)
    if has_h.any():
        from scipy.spatial import cKDTree

        cand = cKDTree(bb["CA"]).query_pairs(9.0, output_type="ndarray")  # i < j
        if len(cand):
            di = np.concatenate([cand[:, 0], cand[:, 1]])  # donor side
            aj = np.concatenate([cand[:, 1], cand[:, 0]])  # acceptor side
            keep = has_h[di] & (np.abs(di - aj) >= 2)  # no self/neighbor bonds  # noqa: PLR2004
            di, aj = di[keep], aj[keep]
            d_on = np.linalg.norm(bb["N"][di] - bb["O"][aj], axis=1)
            d_cn = np.linalg.norm(bb["N"][di] - bb["C"][aj], axis=1)
            d_oh = np.linalg.norm(h_pos[di] - bb["O"][aj], axis=1)
            d_ch = np.linalg.norm(h_pos[di] - bb["C"][aj], axis=1)
            with np.errstate(divide="ignore"):
                energy = Q1Q2_F * (1.0 / d_on + 1.0 / d_ch - 1.0 / d_oh - 1.0 / d_cn)
            bonded = energy < HBOND_ENERGY_CUTOFF
            hbond[di[bonded], aj[bonded]] = True

    def window_connected(width: int) -> np.ndarray:
        """[n - width] bool: peptide bonds intact over positions i..i+width."""
        if n <= width:
            return np.zeros(0, dtype=bool)
        return np.lib.stride_tricks.sliding_window_view(connected[: n - 1], width).all(axis=1)

    # n-turns: CO(i) -> NH(i+k); hbond[i+k, i] is the -k diagonal
    turn = {}
    for k in (3, 4, 5):
        turn_k = np.zeros(n, dtype=bool)
        if n > k:
            turn_k[: n - k] = np.diagonal(hbond, offset=-k) & window_connected(k)
        turn[k] = turn_k

    # minimal helices: two consecutive k-turns at i-1 and i -> helix at i..i+k-1
    helix = {}
    for k in (3, 4, 5):
        marks = np.zeros(n + k + 1, dtype=np.int32)
        starts = np.flatnonzero(turn[k][:-1] & turn[k][1:]) + 1  # helix start index i
        np.add.at(marks, starts, 1)
        np.add.at(marks, starts + k, -1)
        helix[k] = np.cumsum(marks)[:n] > 0

    # bridges (parallel / antiparallel) -> strand, via shifted hbond matrices
    def shift(m: np.ndarray, dr: int, dc: int) -> np.ndarray:
        """m[i+dr, j+dc] with zero padding."""
        out = np.zeros_like(m)
        rs = slice(max(0, -dr), n - max(0, dr))
        cs = slice(max(0, -dc), n - max(0, dc))
        out[rs, cs] = m[max(0, dr) : n - max(0, -dr), max(0, dc) : n - max(0, -dc)]
        return out

    p1 = shift(hbond, 0, -1) & shift(hbond.T, 0, 1)  # H[i, j-1] & H[j+1, i]
    parallel = p1 | p1.T
    a1 = hbond & hbond.T  # H[i, j] & H[j, i]
    a2 = shift(hbond, 1, -1) & shift(hbond.T, -1, 1)  # H[i+1, j-1] & H[j+1, i-1]
    antiparallel = a1 | a2 | a2.T
    idx = np.arange(n)
    valid_pair = (np.abs(idx[:, None] - idx[None, :]) >= 3) & (idx[:, None] >= 1) & (idx[:, None] <= n - 2)  # noqa: PLR2004
    bridge = (parallel | antiparallel) & valid_pair & valid_pair.T
    strand = bridge.any(axis=1) | bridge.any(axis=0)

    # turns (T): residues i+1..i+k-1 of any k-turn
    turn_t = np.zeros(n, dtype=bool)
    for k in (3, 4, 5):
        marks = np.zeros(n + k + 1, dtype=np.int32)
        starts = np.flatnonzero(turn[k])
        np.add.at(marks, starts + 1, 1)
        np.add.at(marks, starts + k, -1)
        turn_t |= np.cumsum(marks)[:n] > 0

    # bends (S): kappa (CA angle over i-2, i, i+2) > 70 degrees
    bend = np.zeros(n, dtype=bool)
    if n > 4:  # noqa: PLR2004
        u = bb["CA"][2:-2] - bb["CA"][:-4]
        v = bb["CA"][4:] - bb["CA"][2:-2]
        nu = np.linalg.norm(u, axis=1)
        nv = np.linalg.norm(v, axis=1)
        ok = (nu > 0) & (nv > 0)
        cos = np.zeros(len(u))
        cos[ok] = (u[ok] * v[ok]).sum(axis=1) / (nu[ok] * nv[ok])
        kappa = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        conn2 = window_connected(2)  # connected over i..i+2
        both = conn2[: n - 4] & conn2[2 : n - 2]
        bend[2 : n - 2] = (kappa > 70.0) & ok & both  # noqa: PLR2004

    out: dict[int, str] = {}
    for i, r in enumerate(res_ids):
        if helix[4][i]:
            letter = "H"
        elif strand[i]:
            letter = "E"
        elif helix[3][i]:
            letter = "G"
        elif helix[5][i]:
            letter = "I"
        elif turn_t[i]:
            letter = "T"
        elif bend[i]:
            letter = "S"
        else:
            letter = " "
        out[int(r)] = letter
    return out


def _is_proline(arrays, residue_index: int) -> bool:
    from deeprank2_tpu_torch.molstruct.aminoacid import AA_THREE_LETTER

    aa_id = int(arrays.res_aa_ids[residue_index])
    return aa_id >= 0 and AA_THREE_LETTER[aa_id] == "PRO"
