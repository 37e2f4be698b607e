"""Launch layer of the port: the serving driver (``launch.serve``), the
training driver (``launch.train``) and the host mesh over a
``torch.distributed`` group (``launch.mesh``).  The reference's
production mesh, input specs, multi-pod dry run and HLO analysis are
TPU/XLA tooling with no counterpart here (ROADMAP queue 1, item 6)."""
