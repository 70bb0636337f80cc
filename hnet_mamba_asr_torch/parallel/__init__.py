"""The multi-rank planes, counterpart of ``hnet_mamba_asr_tpu/parallel``:
data parallel (DDP), FSDP, sequence parallelism, and tensor and expert
parallelism written into the modules, over ``torch.distributed``
(``mesh.py``, ``collectives.py``, ``seq_parallel.py``,
``model_parallel.py``). Pipeline parallelism is not ported yet."""
