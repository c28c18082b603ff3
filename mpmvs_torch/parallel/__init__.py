"""Scale-out over several GPUs: one process per card, ``torch.distributed``
between them (``mesh``); views over ranks (``view_sharding``), one view's
rows over ranks (``tile_sharding``), the launch across hosts
(``multihost``) and a small self-check over n ranks (``dryrun``)."""
