from .synth import (KeystrokeTraceConfig, MutationEvent, MutationTraceConfig,
                    SynthLogConfig, generate_keystroke_trace,
                    generate_mutation_trace, generate_query_log,
                    make_eval_queries)

__all__ = ["KeystrokeTraceConfig", "MutationEvent", "MutationTraceConfig",
           "SynthLogConfig", "generate_keystroke_trace",
           "generate_mutation_trace", "generate_query_log",
           "make_eval_queries"]
