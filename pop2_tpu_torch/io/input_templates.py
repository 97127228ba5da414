"""Parsers for the reference's per-grid text input files.

The port's copy of the JAX package's ``io/input_templates.py`` (the same
parsers, the same results), built on the port's own ``OverflowSpec`` and
``RegionBox`` and its ``diagnostics.TransportSection``.

The reference ships its real auxiliary input data in-tree as plain text
(``input_templates/``): vertical grids, depth-acceleration profiles,
overflow region/orientation data, region-id tables, section-transport
definitions, and tavg contents files.  These parsers read those exact
formats so the model runs on the reference's real data instead of
synthesized stand-ins.

Formats (reference reader cited per function):
- vert_grid:        ``source/grid.F90:1609-1640`` (read_vert_grid)
- depth_accel:      ``source/time_management.F90:975-1009`` (accel_file)
- overflow infile:  ``source/overflows.F90:300-700`` (init_overflows1);
                    format documented in the file header
                    (``input_templates/gx1v7_overflow:1-40``)
- region_ids:       ``source/grid.F90`` region-name table + marginal-sea
                    balancing entries
- transport_contents: ``source/diagnostics.F90:2010-2125`` (init section
                    transport diagnostics, ``*_transport_contents``)
- tavg_contents:    ``source/tavg.F90:482-`` (per-stream field requests)
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Tuple

import numpy as np

from pop2_tpu_torch.config import OverflowSpec, RegionBox
from pop2_tpu_torch.diagnostics import TransportSection


def read_vert_grid(path: str):
    """Read a POP vert_grid file: one line per level, ``dz zt zw`` in cm
    (the reference reads only column 1 and integrates; the zt/zw columns
    are informational — read_vert_grid, source/grid.F90:1609-1640).

    Returns dz as a float64 array (cm). (grid_files.read_vert_grid is the
    km-checked variant ``grid.build_grid`` uses.)"""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            rows.append(float(parts[0]))
    return np.asarray(rows, dtype=np.float64)


def read_depth_accel(path: str):
    """Read a depth_accel file: one acceleration factor per level
    (dttxcel, source/time_management.F90:975-1009)."""
    vals = []
    with open(path) as f:
        for line in f:
            s = line.strip()
            if not s:
                continue
            vals.append(float(s.split()[0]))
    return np.asarray(vals, dtype=np.float64)


class RegionId(NamedTuple):
    """One row of a *_region_ids file: region number (negative =
    marginal sea), name, and the marginal-sea balancing attributes
    (latitude, longitude, area of the distribution region)."""
    number: int
    name: str
    lat: float
    lon: float
    area: float

    @property
    def is_marginal_sea(self) -> bool:
        return self.number < 0


def read_region_ids(path: str) -> List[RegionId]:
    """Parse a *_region_ids table (region masks / ms_balance inputs)."""
    out = []
    pat = re.compile(r"^\s*(-?\d+)\s+'([^']*)'\s+"
                     r"([\d.eE+-]+)\s+([\d.eE+-]+)\s+([\d.eE+-]+)")
    with open(path) as f:
        for line in f:
            m = pat.match(line)
            if m:
                out.append(RegionId(int(m.group(1)), m.group(2).strip(),
                                    float(m.group(3)), float(m.group(4)),
                                    float(m.group(5))))
    return out


def read_transport_contents(path: str) -> List[TransportSection]:
    """Parse a *_transport_contents file: first line the section count,
    then ``imin imax jmin jmax kmin kmax orient name`` rows (1-based)."""
    out = []
    with open(path) as f:
        lines = [ln.rstrip() for ln in f if ln.strip()]
    n = int(lines[0].split()[0])
    for ln in lines[1:1 + n]:
        parts = ln.split(None, 7)
        i1, i2, j1, j2, k1, k2 = (int(p) for p in parts[:6])
        out.append(TransportSection(i1 - 1, i2 - 1, j1 - 1, j2 - 1,
                                    k1 - 1, k2 - 1, parts[6],
                                    parts[7].strip() if len(parts) > 7
                                    else ""))
    return out


def read_tavg_contents(path: str) -> List[Tuple[int, str]]:
    """Parse a *_tavg_contents file: ``stream field`` rows
    (source/tavg.F90 contents reader). Returns (stream_number, field)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2 and parts[0].isdigit():
                out.append((int(parts[0]), parts[1]))
    return out


# ---------------------------------------------------------------------------
# overflow info file
# ---------------------------------------------------------------------------

def _strip(line: str) -> str:
    return line.split("!", 1)[0].strip()


def read_overflows(path: str) -> Tuple[OverflowSpec, ...]:
    """Parse an overflows_infile (init_overflows1,
    source/overflows.F90:300-700; format per the file's own header).

    All in-file indices are 1-based Fortran T-grid indices; the returned
    spec stores 0-based (i, j, k). Region boxes become RegionBox in
    (k, j, i); the product RegionBox is the bounding box of all product
    sets (insertion happens per selected set, ovf_loc_prd)."""
    with open(path) as f:
        raw = f.readlines()

    # skip the prose header: everything through the second full-width
    # dashed line
    dashed = [idx for idx, ln in enumerate(raw)
              if ln.lstrip().startswith("----")]
    body = raw[(dashed[1] + 1) if len(dashed) >= 2 else 0:]
    lines = [s for s in (_strip(ln) for ln in body) if s]

    pos = 0

    def nxt() -> str:
        nonlocal pos
        s = lines[pos]
        pos += 1
        return s

    def ints(s: str) -> List[int]:
        return [int(tok) for tok in s.split()]

    n_total = int(nxt().split()[0])
    specs = []
    for _ in range(n_total):
        head = nxt()
        m = re.match(r"^\s*(\d+)\s+'([^']*)'", head)
        if not m:
            raise ValueError(f"bad overflow header line: {head!r}")
        name = m.group(2).strip()
        lat = float(nxt().split()[0])
        width = float(nxt().split()[0])
        source_thick = float(nxt().split()[0])
        distnc = float(nxt().split()[0])
        slope = float(nxt().split()[0])
        drag = float(nxt().split()[0])

        n_kmt = int(nxt().split()[0])
        kmt_changes = []
        for _ in range(n_kmt):
            i, j, old, new = ints(nxt())[:4]
            kmt_changes.append((i - 1, j - 1, old, new))

        def box(s: str) -> RegionBox:
            i1, i2, j1, j2, k1, k2 = ints(s)[:6]
            return RegionBox(kmin=k1 - 1, kmax=k2 - 1, jmin=j1 - 1,
                             jmax=j2 - 1, imin=i1 - 1, imax=i2 - 1)

        inf_box = box(nxt())
        src_box = box(nxt())
        ent_box = box(nxt())

        def pts(count: int):
            out = []
            for _ in range(count):
                i, j, k, orient = ints(nxt())[:4]
                out.append((i - 1, j - 1, k - 1, orient))
            return tuple(out)

        src_pts = pts(int(nxt().split()[0]))
        ent_pts = pts(int(nxt().split()[0]))
        n_sets = int(nxt().split()[0])
        prd_sets = []
        for _ in range(n_sets):
            prd_sets.append(pts(int(nxt().split()[0])))

        # product bounding box over all sets (k, j, i)
        all_pts = [p for s in prd_sets for p in s]
        prd_box = RegionBox(
            kmin=min(p[2] for p in all_pts), kmax=max(p[2] for p in all_pts),
            jmin=min(p[1] for p in all_pts), jmax=max(p[1] for p in all_pts),
            imin=min(p[0] for p in all_pts), imax=max(p[0] for p in all_pts))

        specs.append(OverflowSpec(
            name=name, lat=lat, width=width, source_thick=source_thick,
            distnc_str_ssb=distnc, bottom_slope=slope, bottom_drag=drag,
            inf=inf_box, src=src_box, ent=ent_box, prd=prd_box,
            kmt_changes=tuple(kmt_changes), src_pts=src_pts,
            ent_pts=ent_pts, prd_sets=tuple(prd_sets)))
    return tuple(specs)
