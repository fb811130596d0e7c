"""Beyond-paper demo: ARCO tunes the pod-level execution configuration,
on the PyTorch port.

    PYTHONPATH=src python -m repro_torch.examples.arco_sharding_search \\
        --arch qwen2-1.5b --shape train_4k --budget 10 [--device cpu]

Each "hardware measurement" is the port's meta-device dry-run of a
256-device cell (``repro_torch.launch.dryrun``: dot FLOPs counted on
``meta``, collectives modelled from the placements) + roofline analysis —
the expensive-oracle regime the paper's Confidence Sampling targets.  The
agents and the GBT run on ``--device`` (default cuda).
"""
from repro_torch.launch.autotune import main

if __name__ == "__main__":
    main()
