"""Multi-device execution of the port: pair-batch sharding over a mesh of
torch devices (``engine``), multi-process file scoring and alignment over
``torch.distributed`` (``distributed``), one pair's lanes split over the
mesh (``wavefront_sp``) and the multi-device dry run (``dryrun``)."""
