from repro_torch.workloads.tpcc import TPCCWorkload
from repro_torch.workloads.ycsb import YCSBWorkload

__all__ = ["YCSBWorkload", "TPCCWorkload"]
