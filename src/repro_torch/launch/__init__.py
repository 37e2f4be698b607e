"""Launch layer of the port: the serving driver (``launch.serve``) and the
training driver (``launch.train``).  The reference's production mesh,
input specs, multi-pod dry run and HLO analysis are TPU/XLA tooling with
no counterpart here (ROADMAP queue 1, item 6)."""
