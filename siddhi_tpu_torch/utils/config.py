"""Config system (port of `siddhi_tpu/utils/config.py`): the ConfigManager
SPI, the in-memory manager and ConfigReader.  The port reads
`optimizer.merge.enabled`, `serving.enabled`, `serving.ring.capacity` and
`serving.drain.interval.ms` from the manager's properties.

Reference (what, not how): CORE/util/config/ConfigManager.java,
InMemoryConfigManager.java, YAMLConfigManager.java:40 and ConfigReader —
system-wide properties (e.g. ``shardId``, ``partitionById`` for distributed
incremental aggregation, AggregationParser :173-197) plus per-extension
``namespace.name.key`` config read by operators at plan time.  The ``${var}``
env substitution half of the reference config story lives in
compiler/__init__.py (SiddhiCompiler.update_variables).  The YAML manager
is not ported.
"""
from __future__ import annotations

from typing import Dict, Optional


class ConfigReader:
    """Per-extension config view (reference: CORE/util/config/ConfigReader).

    Keys are looked up as ``<namespace>.<name>.<key>`` in the manager's
    extension config map.
    """

    def __init__(self, namespace: str, name: str,
                 configs: Optional[Dict[str, str]] = None):
        self.namespace = namespace
        self.name = name
        self._configs = configs or {}

    def read_config(self, key: str, default: Optional[str] = None):
        return self._configs.get(
            f"{self.namespace}.{self.name}.{key}", default)

    def get_all_configs(self) -> Dict[str, str]:
        prefix = f"{self.namespace}.{self.name}."
        return {k[len(prefix):]: v for k, v in self._configs.items()
                if k.startswith(prefix)}

    readConfig = read_config
    getAllConfigs = get_all_configs


class ConfigManager:
    """reference: CORE/util/config/ConfigManager interface."""

    def generate_config_reader(self, namespace: str,
                               name: str) -> ConfigReader:
        return ConfigReader(namespace, name, {})

    def extract_system_configs(self) -> Dict[str, str]:
        return {}

    def extract_property(self, name: str) -> Optional[str]:
        return None

    generateConfigReader = generate_config_reader
    extractSystemConfigs = extract_system_configs
    extractProperty = extract_property


class InMemoryConfigManager(ConfigManager):
    """reference: CORE/util/config/InMemoryConfigManager."""

    def __init__(self, configs: Optional[Dict[str, str]] = None,
                 system_configs: Optional[Dict[str, str]] = None):
        self._configs = dict(configs or {})
        self._system_configs = dict(system_configs or {})

    def generate_config_reader(self, namespace, name):
        return ConfigReader(namespace, name, self._configs)

    def extract_system_configs(self):
        return dict(self._system_configs)

    def extract_property(self, name):
        if name in self._system_configs:
            return self._system_configs[name]
        return self._configs.get(name)
