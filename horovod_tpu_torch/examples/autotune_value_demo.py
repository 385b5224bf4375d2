"""Autotune value demo: the tuner discovers the two-level exchange with fp8
on the DCN hop when the link budget rewards it -- and rejects it when it
doesn't (the port of ``examples/autotune_value_demo.py``).

The autotuner picks exchange knobs a user would otherwise hand-tune per
topology.  This demo shows that value without a two-level cluster: rank
0 of an 8-rank recording world (``torch.distributed``'s ``fake``
backend, one process; ``analysis.collective_walk.recording_world``) laid
out as 2 nodes x 4 ranks (``HOROVOD_HIERARCHICAL=2,4``) opens the
hierarchical axis, the per-leg DCN codec axis is opted in
(``HOROVOD_AUTOTUNE_HIER=1``), and each sampled configuration is
"timed" by :func:`horovod_tpu_torch.autotune.modeled_exchange_seconds`,
the analytic ring cost, instead of a wall clock:

* a flat allreduce moves ``2 (n-1)/n * bytes`` over the SLOWEST link its
  ring crosses;
* the hierarchical one moves the full payload inside a node (``2
  (g-1)/g * bytes``, full precision) and only the ``bytes/g`` shard
  across nodes (``2 (d-1)/d``), the DCN codec scaling that hop's wire
  bytes (bf16/fp16 1/2, fp8 1/4) for a fixed quantize cost a step, plus
  one extra phase launch a leg.

Two scenarios bracket the decision:

* ``contended_dcn`` -- 97 MiB gradients, 40 GB/s inside a node, 1 GB/s
  across: the tuner should lock hierarchical=1 + fp8 on the DCN hop;
* ``uniform_fast``  -- 4 MiB gradients, every link 40 GB/s, quantize 5
  ms: the codec and the second phase can only lose -- hierarchical=0, no
  codec.

The cold-start tuner samples the 5-configuration grid (flat, and the
two-level schedule with each of 4 DCN codecs) exhaustively and locks the
modeled winner.  The selections and the modeled cost table go to
``--out`` (or ``AUTOTUNE_DEMO_OUT``), by default a file in a new
temporary directory.  Run::

    python -m horovod_tpu_torch.examples.autotune_value_demo --device cpu

The recording world lives on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

_MiB = 1024 * 1024

SCENARIOS = {
    "contended_dcn": {
        "payload_bytes": 97 * _MiB,
        "ici_bw": 40e9,          # bytes/s a link
        "dcn_bw": 1e9,
        "quantize_s": 0.0005,    # a cheap on-chip cast
        "phase_overhead_s": 0.0002,
        "expect": {"hierarchical": 1, "codec": "fp8"},
    },
    "uniform_fast": {
        "payload_bytes": 4 * _MiB,
        "ici_bw": 40e9,
        "dcn_bw": 40e9,
        "quantize_s": 0.005,     # dominates a ~0.2 ms wire
        "phase_overhead_s": 0.0002,
        "expect": {"hierarchical": 0, "codec": "none"},
    },
}

DCN_GROUPS, ICI_GROUP = 2, 4   # the (2, 4) two-level layout

_CODEC_SCALE = {"none": 1.0, "bf16": 0.5, "fp16": 0.5, "fp8": 0.25}


def codec_name(compression) -> str:
    """A codec (or None, the configured default) -> the scale table's
    key.  A per-leg composite reports its DCN leg: that is the hop the
    model prices the codec on."""
    if compression is None:
        return "none"
    if getattr(compression, "wire_format", "") == "hier_legs":
        compression = compression.dcn
    name = compression.__name__.lower()
    for k in ("bf16", "fp16", "fp8"):
        if k in name:
            return k
    return "none"


def modeled_step_seconds(hierarchical: bool, codec: str, sc: dict) -> float:
    """Analytic exchange time of one step under the scenario's links;
    ``codec`` is the DCN leg's for a hierarchical configuration (the node
    legs stay full precision) and the whole exchange's for a flat one."""
    from horovod_tpu_torch.autotune import modeled_exchange_seconds
    scale = _CODEC_SCALE[codec]
    quant = sc["quantize_s"] if codec != "none" else 0.0
    if hierarchical:
        return modeled_exchange_seconds(
            sc["payload_bytes"], n_dcn=DCN_GROUPS, n_ici=ICI_GROUP,
            hierarchical=True, ici_bw=sc["ici_bw"], dcn_bw=sc["dcn_bw"],
            ici_wire_scale=1.0, dcn_wire_scale=scale, quantize_s=quant,
            phase_overhead_s=sc["phase_overhead_s"])
    return modeled_exchange_seconds(
        sc["payload_bytes"], n_dcn=DCN_GROUPS, n_ici=ICI_GROUP,
        hierarchical=False, ici_bw=sc["ici_bw"], dcn_bw=sc["dcn_bw"],
        ici_wire_scale=scale, quantize_s=quant,
        phase_overhead_s=sc["phase_overhead_s"])


def cost_table(sc: dict) -> dict:
    return {f"hier{h}_{c}": round(modeled_step_seconds(bool(h), c, sc) * 1e3,
                                  3)
            for h in (0, 1) for c in ("none", "bf16", "fp16", "fp8")}


def run_scenario(name: str) -> dict:
    """Cold-start tune under the scenario's link model, inside an
    initialized two-level world; returns the locked selection."""
    from horovod_tpu_torch.autotune import Autotuner, _layout_is_two_level
    from horovod_tpu_torch.core.state import global_state

    sc = SCENARIOS[name]
    assert _layout_is_two_level(), \
        "run_scenario needs a world laid out in two levels"
    saved = os.environ.get("HOROVOD_AUTOTUNE_HIER")
    os.environ["HOROVOD_AUTOTUNE_HIER"] = "1"
    try:
        # One pinned threshold x pinned cycle x {flat, hier x 4 DCN
        # codecs}: a 5-configuration grid sampled exhaustively.
        cfg = dataclasses.replace(global_state().config, autotune=True,
                                  autotune_log=None)
        tuner = Autotuner(cfg, steps_per_sample=1,
                          candidates=[64 * _MiB], max_samples=5,
                          cycle_candidates=[cfg.cycle_time])
        assert tuner.tunes_hier_codec
        assert len(tuner.grid) == 5, len(tuner.grid)
        guard = 0
        while not tuner.done and guard < 100:
            t = modeled_step_seconds(
                tuner.hierarchical_explicit(),
                codec_name(tuner.compression_override(None)), sc)
            tuner.record_step(t, sc["payload_bytes"])
            guard += 1
        assert tuner.done, "tuner failed to lock within the guard budget"
    finally:
        if saved is None:
            del os.environ["HOROVOD_AUTOTUNE_HIER"]
        else:
            os.environ["HOROVOD_AUTOTUNE_HIER"] = saved
    picked = {"hierarchical": int(tuner.hierarchical_explicit()),
              "codec": codec_name(tuner.compression_override(None))}
    return {"scenario": name,
            "selected": picked,
            "expected": sc["expect"],
            "matches_model_optimum": picked == sc["expect"],
            "sampled_configs": len(tuner._samples),
            "modeled_ms": cost_table(sc)}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="where the JSON record goes (default: "
                        "AUTOTUNE_DEMO_OUT, else a new temporary "
                        "directory)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Tune both scenarios; returns the record written to ``--out``
    (``out`` holds its path).  Raises if a selection misses the model's
    optimum."""
    args = parse_args(argv)
    from horovod_tpu_torch.analysis.collective_walk import recording_world
    from horovod_tpu_torch.core.device import resolve_device
    dev = resolve_device(args.device)
    with recording_world(DCN_GROUPS * ICI_GROUP, 0, device=dev,
                         hierarchical=(DCN_GROUPS, ICI_GROUP)):
        results = [run_scenario(name) for name in SCENARIOS]
    out_path = args.out or os.environ.get("AUTOTUNE_DEMO_OUT") or \
        os.path.join(tempfile.mkdtemp(prefix="autotune_demo_"),
                     "AUTOTUNE_DEMO.json")
    doc = {"demo": "autotune_value_demo",
           "mesh": f"recording world ({DCN_GROUPS}, {ICI_GROUP}) two-level",
           "results": results}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    for r in results:
        print(f"{r['scenario']}: selected {r['selected']} "
              f"(expected {r['expected']}) -- "
              f"{'OK' if r['matches_model_optimum'] else 'MISMATCH'}",
              flush=True)
    print(f"wrote {out_path}", flush=True)
    if not all(r["matches_model_optimum"] for r in results):
        raise AssertionError("a selection missed the model's optimum")
    doc["out"] = out_path
    return doc


if __name__ == "__main__":
    main()
    sys.exit(0)
