from elasticsearch_tpu_torch.script.engine import (
    CompiledScript, ScriptEngine, ScriptException, default_engine,
    execute_update_script,
)

__all__ = ["CompiledScript", "ScriptEngine", "ScriptException",
           "default_engine", "execute_update_script"]
