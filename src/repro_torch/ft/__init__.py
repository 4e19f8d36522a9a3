from repro_torch.ft.failures import FailureInjector, SimulatedFailure

__all__ = ["FailureInjector", "SimulatedFailure"]
