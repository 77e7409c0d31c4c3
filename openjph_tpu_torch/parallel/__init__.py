"""Scale-out: tile mosaics over a device mesh (tiles.py, mesh.py), the
row-sharded DWT with halo exchange over torch.distributed
(dwt_sharded.py), and the frame fan-out across processes
(multihost.py)."""
from .mesh import (Mesh, decode_blocks_sharded, make_mesh,  # noqa: F401
                   pad_to_multiple)
from .tiles import (MosaicDecoder, MosaicEncoder, decode_mosaic,  # noqa: F401
                    encode_mosaic)
