"""The interpretability suite, counterpart of ``hnet_mamba_asr_tpu/interp/``:
forced alignments (``alignments``), boundary F1 against them
(``boundary_align``), linear probes (``probes``) and the reports
(``driver``: boundaries, probes, robustness, emergence)."""
