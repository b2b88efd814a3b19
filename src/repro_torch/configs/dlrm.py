"""dlrm — the paper's own workload (§8): DLRM behind the BALBOA service
chain (Neg2Zero -> Log on dense, Modulus on sparse), streamed from
disaggregated storage directly to device memory.
[arXiv:1906.00091; paper Figs 9-11]"""
from repro_torch.common.config import DLRMConfig

ARCH_ID = "dlrm"


def config() -> DLRMConfig:
    return DLRMConfig()


def smoke_config() -> DLRMConfig:
    return DLRMConfig(embed_rows=1000, embed_dim=16,
                      bottom_mlp=(32, 16), top_mlp=(32, 1), modulus=1000)
