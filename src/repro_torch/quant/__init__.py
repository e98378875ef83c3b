"""(1, e, m) formats, the plain quantizer, the int8 code layout and the
software accumulators (counterpart of ``repro.quant``)."""
from repro_torch.quant.formats import (  # noqa: F401
    BF16_LIKE,
    FP8_152,
    FP16_161,
    FP32_LIKE,
    FPFormat,
)
from repro_torch.quant.qnum import quantize  # noqa: F401
from repro_torch.quant.qtensor import (  # noqa: F401
    QTensor,
    pack_block,
    pack_tree,
    unpack_block,
    unpack_tree,
)
from repro_torch.quant.accumulate import (  # noqa: F401
    chunked_accumulate,
    sequential_accumulate,
    swamped_variance,
)
