"""Model families: Llama, Mixtral, GPT-NeoX, CodeGen and DBRX, exported
under the JAX package's names (``neuronx_distributed_tpu/models/__init__.py``;
BERT and ViT are not ported yet)."""

from neuronx_distributed_tpu_torch.models.codegen import (
    CodeGenConfig,
    CodeGenForCausalLM,
    codegen25_7b,
    tiny_codegen,
)
from neuronx_distributed_tpu_torch.models.dbrx import (
    DbrxConfig,
    DbrxForCausalLM,
    dbrx_base,
    tiny_dbrx,
)
from neuronx_distributed_tpu_torch.models.gpt_neox import (
    GPTNeoXConfig,
    GPTNeoXForCausalLM,
    gpt_neox_20b,
    tiny_gpt_neox,
)
from neuronx_distributed_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaModel,
    llama2_7b,
    llama2_70b,
    llama3_8b,
    tiny_llama,
)
from neuronx_distributed_tpu_torch.models.mixtral import (
    MixtralConfig,
    MixtralForCausalLM,
    MixtralModel,
    mixtral_8x7b,
    tiny_mixtral,
)

__all__ = [
    "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
    "llama2_7b", "llama2_70b", "llama3_8b", "tiny_llama",
    "MixtralConfig", "MixtralForCausalLM", "MixtralModel",
    "mixtral_8x7b", "tiny_mixtral",
    "GPTNeoXConfig", "GPTNeoXForCausalLM", "gpt_neox_20b", "tiny_gpt_neox",
    "DbrxConfig", "DbrxForCausalLM", "dbrx_base", "tiny_dbrx",
    "CodeGenConfig", "CodeGenForCausalLM", "codegen25_7b", "tiny_codegen",
]
