"""The multi-rank planes, counterpart of ``hnet_mamba_asr_tpu/parallel``:
data parallel (DDP), FSDP and sequence parallelism over ``torch.distributed``
(``mesh.py``, ``collectives.py``, ``seq_parallel.py``). Tensor, expert and
pipeline parallelism are not ported yet."""
