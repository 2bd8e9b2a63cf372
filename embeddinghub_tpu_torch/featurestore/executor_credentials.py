"""Typed executor / credential / catalog configs for the registration
surface.

The reference SDK validates provider-executor credentials client-side
before anything hits the wire (reference
client/src/featureform/resources.py:199-346 AWS/GCP credential
dataclasses, :1007-1045 GlueCatalog, :1268-1313 SparkFlags,
:3329-3470 Databricks/EMR, :3473-3594 generic Spark).  This module
rebuilds that surface: each object validates at construction and
serializes to the plain dict that `Registrar.register_provider` stores
on the Provider resource, so `register_spark(executor=...)` carries
exactly the information the reference's Go providers would unpack.

No external infra exists in this image — these are configuration
carriers (the equivalence hash and apply-plan tests exercise them),
and the TransformEngine seam (`transform_engine.register_engine`) is
where a real Spark/EMR executor would attach.
"""

from __future__ import annotations

import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

from .fferr import InvalidResourceError

__all__ = [
    "AWSStaticCredentials",
    "AWSAssumeRoleCredentials",
    "GCPCredentials",
    "BasicCredentials",
    "KerberosCredentials",
    "DatabricksCredentials",
    "EMRCredentials",
    "SparkCredentials",
    "GlueCatalog",
    "SparkFlags",
]

_SUPPORTED_PY_MINORS = ("9", "10", "11", "12")
# the executor docker images pin one patch release per minor
_PY_PATCH = {"9": "16", "10": "10", "11": "2", "12": "0"}


def _require(cond: bool, msg: str):
    if not cond:
        raise InvalidResourceError(msg)


# ---------------------------------------------------------------- creds


@dataclass
class AWSStaticCredentials:
    """Static key-pair AWS credentials (resources.py:199-240)."""

    access_key: str = ""
    secret_key: str = ""

    def __post_init__(self):
        _require(self.access_key != "", "AWSStaticCredentials access_key cannot be empty")
        _require(self.secret_key != "", "AWSStaticCredentials secret_key cannot be empty")

    @staticmethod
    def type() -> str:
        return "AWS_STATIC_CREDENTIALS"

    def config(self) -> dict:
        return {
            "AccessKeyId": self.access_key,
            "SecretKey": self.secret_key,
            "Type": self.type(),
        }


@dataclass
class AWSAssumeRoleCredentials:
    """IRSA / default-provider-chain AWS credentials — carries no
    secrets; the executor pod resolves its own role
    (resources.py:243-270)."""

    @staticmethod
    def type() -> str:
        return "AWS_ASSUME_ROLE_CREDENTIALS"

    def config(self) -> dict:
        return {"Type": self.type()}


@dataclass
class GCPCredentials:
    """GCP service-account credentials: a project id plus either a
    key-file path (read eagerly so apply() fails fast on a bad path)
    or the already-parsed JSON dict (resources.py:272-329)."""

    project_id: str = ""
    credentials_path: str = ""
    credentials_json: Optional[dict] = None

    def __post_init__(self):
        _require(self.project_id != "", "GCPCredentials project_id cannot be empty")
        if self.credentials_json is None:
            _require(
                self.credentials_path != "",
                "GCPCredentials needs credentials_path or credentials_json",
            )
            import json as _json
            import os as _os

            _require(
                _os.path.isfile(self.credentials_path),
                f"GCPCredentials file not found: {self.credentials_path}",
            )
            with open(self.credentials_path) as f:
                self.credentials_json = _json.load(f)

    @staticmethod
    def type() -> str:
        return "GCP_CREDENTIALS"

    def config(self) -> dict:
        return {
            "ProjectId": self.project_id,
            "JSON": self.credentials_json,
            "Type": self.type(),
        }


@dataclass
class BasicCredentials:
    """Username/password credentials (HDFS et al., resources.py:331-372)."""

    username: str = ""
    password: str = ""

    def __post_init__(self):
        _require(self.username != "", "BasicCredentials username cannot be empty")

    @staticmethod
    def type() -> str:
        return "BASIC_CREDENTIALS"

    def config(self) -> dict:
        return {
            "Username": self.username,
            "Password": self.password,
            "Type": self.type(),
        }


@dataclass
class KerberosCredentials:
    """Kerberos principal credentials (resources.py:374-420)."""

    username: str = ""
    password: str = ""
    krb5_conf: str = ""

    def __post_init__(self):
        _require(self.username != "", "KerberosCredentials username cannot be empty")
        _require(self.krb5_conf != "", "KerberosCredentials krb5_conf cannot be empty")

    @staticmethod
    def type() -> str:
        return "KERBEROS_CREDENTIALS"

    def config(self) -> dict:
        return {
            "Username": self.username,
            "Password": self.password,
            "Krb5Conf": self.krb5_conf,
            "Type": self.type(),
        }


# ------------------------------------------------------------ executors


@dataclass
class DatabricksCredentials:
    """Databricks executor: exactly ONE auth mode — username+password
    or host+token — plus an existing cluster id
    (resources.py:3329-3420, incl. the id/token format checks)."""

    username: str = ""
    password: str = ""
    host: str = ""
    token: str = ""
    cluster_id: str = ""

    def __post_init__(self):
        by_token = not self.username and not self.password and self.host and self.token
        by_password = self.username and self.password and not self.host and not self.token
        _require(
            bool(by_token) ^ bool(by_password),
            "DatabricksCredentials takes exactly one credential set: "
            "username+password OR host+token",
        )
        _require(self.cluster_id != "", "DatabricksCredentials needs an existing cluster_id")
        _require(
            re.match(r"^\w{4}-\w{6}-\w{8}$", self.cluster_id) is not None,
            f"Invalid Databricks cluster_id {self.cluster_id!r}: "
            "expected 'xxxx-xxxxxx-xxxxxxxx'",
        )
        if self.token:
            _require(
                re.match(r"^dapi[a-zA-Z0-9]{32}(-[a-zA-Z0-9])?$", self.token) is not None,
                "Invalid Databricks token: expected 'dapi' + 32 alphanumerics "
                "(optional '-x' suffix)",
            )

    @staticmethod
    def type() -> str:
        return "DATABRICKS"

    def config(self) -> dict:
        return {
            "Username": self.username,
            "Password": self.password,
            "Host": self.host,
            "Token": self.token,
            "Cluster": self.cluster_id,
        }


@dataclass
class EMRCredentials:
    """EMR executor: existing cluster id + region + AWS credentials
    (resources.py:3425-3470)."""

    emr_cluster_id: str = ""
    emr_cluster_region: str = ""
    credentials: Union[AWSStaticCredentials, AWSAssumeRoleCredentials, None] = None

    def __post_init__(self):
        _require(self.emr_cluster_id != "", "EMRCredentials needs emr_cluster_id")
        _require(self.emr_cluster_region != "", "EMRCredentials needs emr_cluster_region")
        _require(self.credentials is not None, "EMRCredentials needs AWS credentials")

    @staticmethod
    def type() -> str:
        return "EMR"

    def config(self) -> dict:
        return {
            "ClusterName": self.emr_cluster_id,
            "ClusterRegion": self.emr_cluster_region,
            "Credentials": self.credentials.config(),
        }


@dataclass
class SparkCredentials:
    """Generic spark-submit executor (resources.py:3473-3594):
    master/deploy-mode as spark-submit takes them, a 3.9-3.12 python
    pin resolved to the executor image's patch release, and the yarn
    site files required when master is yarn (file contents travel in
    the config so the executor needs no shared filesystem)."""

    master: str = ""
    deploy_mode: str = ""
    python_version: str = ""
    core_site_path: str = ""
    yarn_site_path: str = ""

    def __post_init__(self):
        self.master = self.master.lower()
        self.deploy_mode = self.deploy_mode.lower()
        _require(
            self.deploy_mode in ("cluster", "client"),
            f"Spark deploy_mode {self.deploy_mode!r} unsupported: "
            "'cluster' or 'client'",
        )
        if self.master == "yarn":
            _require(
                self.core_site_path != "" and self.yarn_site_path != "",
                "master='yarn' needs core_site_path and yarn_site_path",
            )
        self.python_version = self._pin_python(self.python_version)

    def _pin_python(self, version: str) -> str:
        if version == "" and self.deploy_mode == "cluster":
            vi = sys.version_info
            minor = str(vi.minor) if str(vi.minor) in _SUPPORTED_PY_MINORS else "9"
            version = f"3.{minor}"
        parts = version.split(".")
        _require(
            len(parts) in (2, 3),
            "python_version must be 'major.minor' or 'major.minor.patch'",
        )
        major, minor = parts[0], parts[1]
        _require(
            major == "3" and minor in _SUPPORTED_PY_MINORS,
            f"Python {version} unsupported on Spark executors (3.9-3.12)",
        )
        return f"3.{minor}.{_PY_PATCH[minor]}"

    @staticmethod
    def type() -> str:
        return "SPARK"

    def config(self) -> dict:
        def slurp(path):
            if not path:
                return ""
            with open(path) as f:
                return f.read()

        return {
            "Master": self.master,
            "DeployMode": self.deploy_mode,
            "PythonVersion": self.python_version,
            "CoreSite": slurp(self.core_site_path),
            "YarnSite": slurp(self.yarn_site_path),
        }


# ------------------------------------------------------------- catalogs


@dataclass
class GlueCatalog:
    """AWS Glue table catalog for Spark offline stores
    (resources.py:1007-1045).  Iceberg needs warehouse + region."""

    region: str = ""
    database: str = ""
    warehouse: str = ""
    assume_role_arn: str = ""
    table_format: str = "ICEBERG"

    def __post_init__(self):
        _require(self.database != "", "GlueCatalog database cannot be empty")
        _require(
            all(c.isalnum() or c == "_" for c in self.database),
            "GlueCatalog database must be alphanumeric/underscore",
        )
        self.table_format = self.table_format.upper()
        _require(
            self.table_format in ("ICEBERG", "DELTA"),
            f"GlueCatalog table_format {self.table_format!r}: ICEBERG or DELTA",
        )
        if self.table_format == "ICEBERG":
            _require(self.warehouse != "", "Iceberg GlueCatalog needs a warehouse")
            _require(self.region != "", "Iceberg GlueCatalog needs a region")

    def config(self) -> dict:
        return {
            "Database": self.database,
            "Warehouse": self.warehouse,
            "Region": self.region,
            "AssumeRoleArn": self.assume_role_arn,
            "TableFormat": self.table_format,
        }


@dataclass
class SparkFlags:
    """Per-job spark-submit params / writer options / table properties
    (resources.py:1268-1313)."""

    spark_params: Dict[str, str] = field(default_factory=dict)
    write_options: Dict[str, str] = field(default_factory=dict)
    table_properties: Dict[str, str] = field(default_factory=dict)

    def serialize(self) -> dict:
        return {
            "SparkParams": dict(self.spark_params),
            "WriteOptions": dict(self.write_options),
            "TableProperties": dict(self.table_properties),
        }

    @classmethod
    def deserialize(cls, config: Optional[dict]) -> Optional["SparkFlags"]:
        if not config:
            return None
        return cls(
            spark_params=config.get("SparkParams", {}),
            write_options=config.get("WriteOptions", {}),
            table_properties=config.get("TableProperties", {}),
        )
