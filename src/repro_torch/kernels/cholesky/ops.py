"""Public Cholesky tile ops.

``update`` is the trailing update whose wave groups run on the batched
tile-update kernel
(:func:`repro_torch.kernels.matmul.kernel.tile_update_batched`) through
the wave registry; ``potrf`` and ``trsm`` stay on ``torch.linalg`` (see
ref.py for why).
"""
from . import ref

potrf = ref.potrf
trsm = ref.trsm
update = ref.update
