"""``repro_torch.compiler.netopt`` — network-scope HW/SW co-optimization.

K accelerator configurations for the whole DNN (K=1: one shared chip;
K=2..3: a heterogeneous pipeline over contiguous network cuts), per-layer
software mappings under them: an outer partition search (network-scope GBT
+ Confidence Sampling over :class:`PartitionSpace`) drives inner
pinned-subspace :class:`~repro_torch.compiler.session.Session`\\ s
(``DesignSpace.pin`` per layer, shared software GBT, per-(hw, layer[,
segment]) JSONL warm resume).  The result is a typed :class:`NetworkReport`
whose JSON documents cross between this package and the reference's.

Quickstart::

    from repro_torch.compiler.task import TuningTask
    from repro_torch.compiler.netopt import NetworkCoOptimizer, NetOptConfig
    rep = NetworkCoOptimizer(TuningTask.conv_tasks("resnet-18"),
                             NetOptConfig(layer_budget=16, k_chips=2),
                             records="artifacts/r18.netopt.jsonl",
                             name="resnet-18").run()
    print(rep.summary())

CLI: ``python -m repro_torch.compiler.cli netopt --model resnet-18``.
"""
from repro_torch.compiler.netopt.hwspace import (HW_KNOB_NAMES, HW_KNOBS,
                                                 HwCandidateSpace, hw_dict,
                                                 hw_tag)
from repro_torch.compiler.netopt.partition import HwPartition, PartitionSpace
from repro_torch.compiler.netopt.loop import (NetOptConfig,
                                              NetworkCoOptimizer,
                                              netopt_tune,
                                              network_hw_frozen_tune,
                                              network_random_hw_tune)
from repro_torch.compiler.netopt.genetic import network_genetic_hw_tune
from repro_torch.compiler.netopt.report import NetworkReport

__all__ = [
    "HW_KNOBS", "HW_KNOB_NAMES", "HwCandidateSpace", "hw_dict", "hw_tag",
    "HwPartition", "PartitionSpace",
    "NetOptConfig", "NetworkCoOptimizer", "NetworkReport", "netopt_tune",
    "network_hw_frozen_tune", "network_random_hw_tune",
    "network_genetic_hw_tune",
]
