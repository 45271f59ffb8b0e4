"""Spatially sharded int8 codec on ``torch.distributed`` ranks: rank meshes
(``mesh``), the process runtime (``distributed``), halo-exchanged tiles
(``spatial``) and each rank's entropy stage (``entropy_sharded``)."""
