"""Checkpoint and resume.

Counterpart of ``bayesfast_tpu/utils/checkpoint.py``. Traces carry their
whole sampler state (the driver's carry), so a pickled trace resumes
mid-run bit for bit, and a pickled Recipe resumes at its next unfinished
phase.

``save`` lowers every ``torch.Tensor`` it meets, at any depth of the
object graph (a ``reducer_override`` pickler), to a CPU tensor: a CUDA
tensor pickled as it is would load only where that device exists. The
resuming ``sample()`` moves the carry to ``config.get_device()``, so a
trace saved on the GPU continues on the CPU and the other way round.
"""

import pickle

import torch

__all__ = ['save', 'load']


class _HostPickler(pickle.Pickler):
    """Pickler that lowers device tensors to CPU tensors on the fly."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != 'cpu':
            return obj.detach().cpu().__reduce_ex__(pickle.HIGHEST_PROTOCOL)
        return NotImplemented


def save(obj, path):
    """Pickle a trace, TraceTuple or Recipe with every tensor on the
    CPU."""
    with open(path, 'wb') as f:
        _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)


def load(path):
    """Load an object saved with ``save``; its tensors come back on the
    CPU, and ``sample()`` moves a trace's carry to the configured device
    when it resumes."""
    with open(path, 'rb') as f:
        return pickle.load(f)
