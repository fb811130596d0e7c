"""Generate the dry-run and roofline tables from the port's dry-run
artifacts (``python -m repro_torch.launch.dryrun --out DIR``).

    PYTHONPATH=src python -m repro_torch.tools.make_tables [DIR]

DIR defaults to ``artifacts/dryrun``.  The port's artifact is an estimate
on ``meta`` tensors, not an XLA compile: a field only a compile gives
(``collectives``, ``cost_*``, ``generated_code_size_in_bytes``,
``hlo_chars``, ...) is absent, and a column that reads an absent field
says so (``missing: <field>``) rather than fill in another quantity.  The
roofline columns model the TPU v5e (``repro_torch.hw.roofline``), not the
card.  Nothing here touches a device.
"""
import argparse
import json
import os
import sys

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.hw import roofline as RL


def fmt(x):
    return f"{x:.2e}"


def _field(d, *path):
    """The artifact's value at ``path``, or None where it lacks it."""
    for key in path:
        if not isinstance(d, dict) or key not in d:
            return None
        d = d[key]
    return d


def _cell(d, path, render) -> str:
    v = _field(d, *path)
    return f"missing: {'.'.join(path)}" if v is None else render(v)


def _mesh(d):
    return {p.split('=')[0].strip(): int(p.split('=')[1])
            for p in d['mesh_desc'].split(' x ')}


def load(art_dir: str):
    arts = {}
    for f in sorted(os.listdir(art_dir)):
        if not f.endswith('.json'):
            continue
        with open(os.path.join(art_dir, f)) as fh:
            d = json.load(fh)
        arts[(d['arch'], d['shape'], d['mesh'])] = d
    return arts


def dryrun_table(arts):
    """Both meshes; params/dev over the artifact's own device count."""
    print('## table:dryrun')
    print('| arch | shape | mesh | status | params/dev | temp/dev | HLO dotF/dev | coll B/dev | compile |')
    print('|---|---|---|---|---|---|---|---|---|')
    for (a, s, m), d in sorted(arts.items()):
        if d['status'] == 'skipped':
            print(f"| {a} | {s} | {m} | skipped (full attention) | | | | | |")
            continue
        if d['status'] != 'ok':
            print(f"| {a} | {s} | {m} | {d['status']} | | | | | |")
            continue
        nd = int(np.prod(list(_mesh(d).values())))
        print(f"| {a} | {s} | {m} | ok | "
              + _cell(d, ('param_bytes_global',),
                      lambda v: f"{v / nd / 2**30:.2f} GiB") + " | "
              + _cell(d, ('temp_size_in_bytes',),
                      lambda v: f"{v / 2**30:.1f} GiB*") + " | "
              + _cell(d, ('weighted', 'dot_flops_per_device'), fmt) + " | "
              + _cell(d, ('weighted', 'wire_bytes_per_device'), fmt) + " | "
              + _cell(d, ('compile_s',), lambda v: f"{v:.0f}s") + " |")


def roofline_rows(arts):
    """(arch, shape, Roofline, fraction) of each ok single-pod cell."""
    rows = []
    for (a, s, m), d in sorted(arts.items()):
        if d['status'] != 'ok' or m != 'pod_16x16':
            continue
        cfg = get_config(a)
        cell = SHAPES[s]
        mesh = _mesh(d)
        r = RL.analyze_cell(cfg, cell.kind, cell.seq, cell.global_batch,
                            mesh, d)
        nd = int(np.prod(list(mesh.values())))
        rows.append((a, s, r, RL.roofline_fraction(r, n_dev=nd)))
    return rows


def roofline_table(rows):
    print('## table:roofline')
    print('| arch | shape | compute s | memory s | collective s | dominant | MODEL_FLOPS | MODEL/HLO | roofline frac |')
    print('|---|---|---|---|---|---|---|---|---|')
    for a, s, r, frac in rows:
        print(f"| {a} | {s} | {fmt(r.compute_s)} | {fmt(r.memory_s)} | {fmt(r.collective_s)} "
              f"| **{r.dominant}** | {fmt(r.model_flops)} | {r.usefulness:.2f} | {frac:.3f} |")


def summary(rows):
    doms = {}
    for a, s, r, frac in rows:
        doms.setdefault(r.dominant, []).append((a, s, frac))
    print('## summary')
    for d, cells in doms.items():
        print(f"- {d}-bound: {len(cells)} cells")
    worst = sorted(rows, key=lambda x: x[-1])[:5]
    print('- worst roofline fractions:', [(a, s, round(f, 4)) for a, s, _, f in worst])
    best = sorted(rows, key=lambda x: -x[-1])[:5]
    print('- best roofline fractions:', [(a, s, round(f, 4)) for a, s, _, f in best])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("art_dir", nargs="?", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    arts = load(args.art_dir)
    dryrun_table(arts)
    print()
    rows = roofline_rows(arts)
    roofline_table(rows)
    print()
    summary(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
