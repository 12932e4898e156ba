"""TLS configuration for the data plane (gRPC) and HTTP surfaces.

Reference: pinot-common/.../config/TlsConfig.java:1 + NettyConfig — one
keystore/truststore config shared by every listener and client channel.
Here: PEM file paths resolved from layered configuration
(``pinot.tls.*``), turned into gRPC credentials or an ssl.SSLContext.

Keys (Configuration / PINOT_TPU_ env):
- ``pinot.tls.enabled``      — master switch (default false)
- ``pinot.tls.cert_file``    — server certificate chain (PEM)
- ``pinot.tls.key_file``     — server private key (PEM)
- ``pinot.tls.ca_file``      — trust roots for clients/peers (PEM);
                               defaults to cert_file for self-signed setups
- ``pinot.tls.client_auth``  — require client certificates (mTLS)
- ``pinot.tls.target_name_override`` — expected server cert hostname when
  dialing by IP (test/dev convenience, grpc.ssl_target_name_override)

A copy of pinot_tpu/common/tls.py for the port.
"""

from __future__ import annotations

import dataclasses
import ssl
from typing import Optional


@dataclasses.dataclass
class TlsConfig:
    cert_file: str
    key_file: str
    ca_file: Optional[str] = None
    client_auth: bool = False
    target_name_override: Optional[str] = None

    @classmethod
    def from_config(cls, cfg=None, prefix: str = "pinot.tls") -> Optional["TlsConfig"]:
        """None when TLS is not enabled in the layered config."""
        if cfg is None:
            from pinot_tpu_torch.common.config import Configuration

            cfg = Configuration()
        if not cfg.get_bool(f"{prefix}.enabled", False):
            return None
        cert = cfg.get(f"{prefix}.cert_file")
        key = cfg.get(f"{prefix}.key_file")
        if not cert or not key:
            raise ValueError(
                f"{prefix}.enabled=true requires {prefix}.cert_file and "
                f"{prefix}.key_file")
        return cls(
            cert_file=cert,
            key_file=key,
            ca_file=cfg.get(f"{prefix}.ca_file") or None,
            client_auth=cfg.get_bool(f"{prefix}.client_auth", False),
            target_name_override=cfg.get(f"{prefix}.target_name_override")
            or None,
        )

    # ---- gRPC ------------------------------------------------------------
    def server_credentials(self):
        import grpc

        with open(self.key_file, "rb") as f:
            key = f.read()
        with open(self.cert_file, "rb") as f:
            chain = f.read()
        roots = None
        if self.client_auth:
            with open(self.ca_file or self.cert_file, "rb") as f:
                roots = f.read()
        return grpc.ssl_server_credentials(
            [(key, chain)],
            root_certificates=roots,
            require_client_auth=self.client_auth,
        )

    def channel_credentials(self):
        import grpc

        with open(self.ca_file or self.cert_file, "rb") as f:
            roots = f.read()
        key = chain = None
        if self.client_auth:
            with open(self.key_file, "rb") as f:
                key = f.read()
            with open(self.cert_file, "rb") as f:
                chain = f.read()
        return grpc.ssl_channel_credentials(
            root_certificates=roots, private_key=key, certificate_chain=chain
        )

    def channel_options(self) -> list:
        if self.target_name_override:
            return [("grpc.ssl_target_name_override",
                     self.target_name_override)]
        return []

    # ---- HTTP ------------------------------------------------------------
    def server_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_file, self.key_file)
        if self.client_auth:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.ca_file or self.cert_file)
        return ctx

    def client_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.create_default_context(cafile=self.ca_file or self.cert_file)
        if self.client_auth:
            ctx.load_cert_chain(self.cert_file, self.key_file)
        return ctx


def generate_self_signed(dir_path: str, common_name: str = "localhost",
                         san_ips=("127.0.0.1",)) -> TlsConfig:
    """Dev/test helper: mint a self-signed cert + key under ``dir_path``
    (the reference ships test keystores; here certs are generated on
    demand so none are checked in)."""
    import datetime
    import os

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    import ipaddress

    san = x509.SubjectAlternativeName(
        [x509.DNSName(common_name)]
        + [x509.IPAddress(ipaddress.ip_address(ip)) for ip in san_ips]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(san, critical=False)
        .sign(key, hashes.SHA256())
    )
    os.makedirs(dir_path, exist_ok=True)
    cert_file = os.path.join(dir_path, "tls.crt")
    key_file = os.path.join(dir_path, "tls.key")
    with open(cert_file, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    with open(key_file, "wb") as f:
        f.write(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption(),
        ))
    return TlsConfig(cert_file=cert_file, key_file=key_file,
                     target_name_override=common_name)
