"""Entry points: ``python -m repro_torch.launch.serve`` builds a QAC index
from a synthetic log and serves it on the card in every mode of the JAX
package's launcher (the fused step, ``--routed``, ``--stripes N``,
``--interactive``, ``--online``, ``--cluster N --drill``, ``--freshness``,
``--observe --trace-out``, ``--check``); ``python -m repro_torch.launch.train``
trains any arch; ``launch.mesh`` builds the device meshes. The dry-run and
roofline launchers wait for the mesh lowering of every cell."""
