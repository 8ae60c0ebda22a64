from .synth import SynthLogConfig, generate_query_log

__all__ = ["SynthLogConfig", "generate_query_log"]
