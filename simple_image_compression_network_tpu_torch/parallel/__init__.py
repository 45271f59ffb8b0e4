"""Spatially sharded codecs on ``torch.distributed`` ranks: rank meshes
(``mesh``), the process runtime (``distributed``), halo-exchanged tiles
(``spatial``), each rank's int8 entropy stage (``entropy_sharded``) and the
sharded hyperprior codec (``hyper_sharded``)."""
