from .synth import (KeystrokeTraceConfig, SynthLogConfig,
                    generate_keystroke_trace, generate_query_log)

__all__ = ["KeystrokeTraceConfig", "SynthLogConfig", "generate_keystroke_trace",
           "generate_query_log"]
