"""The port's command-line tools, run as
``python -m hnet_mamba_asr_torch.scripts.<name>``: ``build_manifests``,
``build_tokenizer``, ``compute_cmvn``, ``train``, ``train_lm``,
``export_serving``, ``serve``, ``transcribe``, ``decode``, ``score_wer``,
``run_interp`` (boundary F1, probes, robustness, emergence), ``efficiency``
(the analytic params and GFLOPs report) and ``run_mfa`` (forced alignments
through an external ``mfa``), with the flags and outputs of the JAX
package's ``scripts/<name>.py`` and, where a tool uses the device,
``--device`` (the card by default, and without one they raise; ``--device
cpu`` for the plain path). Configs are
YAML, read by ``utils/config.py``; relative paths in them resolve against
the repository root, as the JAX scripts resolve them.
"""
from hnet_mamba_asr_torch.tasks.build import REPO_ROOT  # noqa: F401
