"""In-process TLS provisioning + webhook self-registration for the VPA
admission controller.

Reference surfaces:
- vertical-pod-autoscaler/pkg/admission-controller/gencerts.sh — CA + server
  key + CA-signed server cert with the service DNS name as CN/SAN.
- certs.go:25-50 (certsContainer: caCert/serverKey/serverCert loaded into the
  TLS config) — here the container is generated in-process instead of read
  from a pre-provisioned secret, so the webhook is self-contained.
- config.go:46-104 (selfRegistration) — MutatingWebhookConfiguration with the
  CA bundle, pod-CREATE rule, failurePolicy Ignore, sideEffects None.

The port's copy of ``autoscaler_tpu/vpa/certs.py``.
"""
from __future__ import annotations

import datetime
import ssl
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID


@dataclass(frozen=True)
class CertBundle:
    """certs.go's certsContainer, PEM-encoded."""

    ca_cert_pem: bytes
    server_cert_pem: bytes
    server_key_pem: bytes

    def server_ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # load_cert_chain only takes paths; stage through a temp dir.
        with tempfile.TemporaryDirectory() as d:
            cert_path, key_path = f"{d}/tls.crt", f"{d}/tls.key"
            with open(cert_path, "wb") as f:
                f.write(self.server_cert_pem)
            with open(key_path, "wb") as f:
                f.write(self.server_key_pem)
            ctx.load_cert_chain(cert_path, key_path)
        return ctx

    def client_ssl_context(self) -> ssl.SSLContext:
        """Context trusting (only) the generated CA — what the apiserver does
        with the webhook's caBundle."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cadata=self.ca_cert_pem.decode())
        return ctx


def _name(cn: str) -> x509.Name:
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def generate_certs(
    service_name: str = "vpa-webhook",
    namespace: str = "kube-system",
    extra_dns_names: Optional[List[str]] = None,
    valid_days: int = 100_000,
) -> CertBundle:
    """gencerts.sh in-process: self-signed CA, then a server cert for
    `<service>.<namespace>.svc` signed by it. ECDSA P-256 (smaller/faster than
    the script's RSA-2048; protocol-equivalent for TLS serving)."""
    now = datetime.datetime(2000, 1, 1, tzinfo=datetime.timezone.utc)
    until = now + datetime.timedelta(days=valid_days)
    svc_dns = f"{service_name}.{namespace}.svc"
    dns_names = [svc_dns, "localhost"] + list(extra_dns_names or ())

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(_name("vpa_webhook_ca"))
        .issuer_name(_name("vpa_webhook_ca"))
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(until)
        .add_extension(x509.BasicConstraints(ca=True, path_length=0), critical=True)
        .add_extension(
            x509.KeyUsage(
                digital_signature=True, key_cert_sign=True, crl_sign=True,
                content_commitment=False, key_encipherment=False,
                data_encipherment=False, key_agreement=False,
                encipher_only=False, decipher_only=False,
            ),
            critical=True,
        )
        .sign(ca_key, hashes.SHA256())
    )

    server_key = ec.generate_private_key(ec.SECP256R1())
    server_cert = (
        x509.CertificateBuilder()
        .subject_name(_name(svc_dns))
        .issuer_name(ca_cert.subject)
        .public_key(server_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(until)
        .add_extension(x509.BasicConstraints(ca=False, path_length=None), critical=True)
        .add_extension(
            x509.SubjectAlternativeName(
                [x509.DNSName(d) for d in dns_names]
                + [x509.IPAddress(__import__("ipaddress").ip_address("127.0.0.1"))]
            ),
            critical=False,
        )
        .add_extension(
            x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.SERVER_AUTH, ExtendedKeyUsageOID.CLIENT_AUTH]
            ),
            critical=False,
        )
        .sign(ca_key, hashes.SHA256())
    )

    return CertBundle(
        ca_cert_pem=ca_cert.public_bytes(serialization.Encoding.PEM),
        server_cert_pem=server_cert.public_bytes(serialization.Encoding.PEM),
        server_key_pem=server_key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


def webhook_configuration(
    bundle: CertBundle,
    service_name: str = "vpa-webhook",
    namespace: str = "kube-system",
    url: Optional[str] = None,
    timeout_seconds: int = 30,
) -> Dict:
    """The MutatingWebhookConfiguration object selfRegistration creates
    (config.go:67-99): pod-CREATE rule, caBundle from the generated CA,
    failurePolicy Ignore so a down webhook never blocks pod creation. Pass
    `url` to register by URL instead of service reference (registerByURL)."""
    import base64

    client_config: Dict = {
        "caBundle": base64.b64encode(bundle.ca_cert_pem).decode()
    }
    # the server only mutates on /mutate (admission.py do_POST); without an
    # explicit path the apiserver would POST to "/" and, under failurePolicy
    # Ignore, every pod would silently admit unpatched
    if url is not None:
        client_config["url"] = url.rstrip("/") + (
            "" if url.rstrip("/").endswith("/mutate") else "/mutate"
        )
    else:
        client_config["service"] = {
            "namespace": namespace,
            "name": service_name,
            "path": "/mutate",
        }
    return {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "MutatingWebhookConfiguration",
        "metadata": {"name": "vpa-webhook-config"},
        "webhooks": [
            {
                "name": "vpa.k8s.io",
                "admissionReviewVersions": ["v1"],
                "rules": [
                    {
                        "operations": ["CREATE"],
                        "apiGroups": [""],
                        "apiVersions": ["v1"],
                        "resources": ["pods"],
                    }
                ],
                "failurePolicy": "Ignore",
                "sideEffects": "None",
                "timeoutSeconds": timeout_seconds,
                "clientConfig": client_config,
            }
        ],
    }
