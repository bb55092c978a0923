"""The plain PyTorch reference of the benchmark's cells: the LEAF frontend,
each backbone (``reference/<arch>.py``, found by the cfg's ``model.arch``),
the classifier around them, the device augment's draws, the losses, Adam
with coupled L2 and the schedules. It imports nothing of ``leaf_tpu_torch``
and takes nothing the port has made: the benchmark makes the weights and
the inputs and hands the same to both sides.

Module and parameter names are the reference leaf-pytorch ``state_dict``
names (the port keeps them too), so the weights the benchmark makes load
into the port by name.
"""
