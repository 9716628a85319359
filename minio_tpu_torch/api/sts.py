"""STS: temporary credentials (AssumeRole + federation variants).

Role of the reference's cmd/sts-handlers.go:
  * AssumeRole (:184) — signed with long-lived user credentials, returns
    short-lived credentials inheriting (optionally narrowing via Policy)
    the parent's permissions.
  * AssumeRoleWithWebIdentity / AssumeRoleWithClientGrants (:301) — OIDC
    JWT authenticated (anonymous HTTP), policies mapped from a token claim
    (internal/config/identity/openid claim_name, default "policy").
  * AssumeRoleWithCertificate (:606) — mTLS client certificate, policy
    named by the certificate CN.
  * AssumeRoleWithLDAPIdentity (:419) — LDAP lookup-bind + user bind via
    the zero-dep BER client (control/ldap.py); user/group DNs map to
    policies through the IAM LDAP policy DB. Reports NotImplemented when
    identity_ldap is unconfigured, the reference's behavior.

Zero-egress: OIDC verification uses a static JWKS / shared secret from the
identity_openid config subsystem, not issuer discovery.
"""

from __future__ import annotations

import json
import time
import urllib.parse
from xml.sax.saxutils import escape

from aiohttp import web

from ..control.iam import IAMSys
from . import jwt as jwt_mod
from .errors import S3Error

STS_VERSION = "2011-06-15"
MIN_DURATION = 900
MAX_DURATION = 7 * 24 * 3600


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def handle_sts(
    iam: IAMSys,
    access_key: str,
    form: dict[str, str],
    config=None,
    request: web.Request | None = None,
) -> web.Response:
    """Dispatch an STS action. AssumeRole needs a signed principal; the
    federation variants authenticate by token/certificate instead."""
    action = form.get("Action", "")
    if action == "AssumeRole":
        return _assume_role(iam, access_key, form)
    if action == "AssumeRoleWithWebIdentity":
        return _assume_role_with_token(
            iam, config, form, form.get("WebIdentityToken", ""), action
        )
    if action == "AssumeRoleWithClientGrants":
        return _assume_role_with_token(iam, config, form, form.get("Token", ""), action)
    if action == "AssumeRoleWithCertificate":
        return _assume_role_with_certificate(iam, config, form, request)
    if action == "AssumeRoleWithLDAPIdentity":
        return _assume_role_with_ldap(iam, config, form)
    raise S3Error("NotImplemented", f"STS action {action}")


def _duration(form: dict[str, str], default: int = 3600) -> int:
    duration = int(form.get("DurationSeconds", str(default)))
    return max(MIN_DURATION, min(duration, MAX_DURATION))


def _session_policy(form: dict[str, str]) -> dict | None:
    if form.get("Policy"):
        try:
            doc = json.loads(form["Policy"])
        except ValueError:
            raise S3Error("MalformedXML", "invalid session policy")
        from ..control import policy as policy_mod

        try:
            policy_mod.Policy.from_dict(doc).validate()
        except ValueError as e:
            raise S3Error("MalformedXML", f"invalid session policy: {e}")
        return doc
    return None


def _creds_xml(action: str, creds, expiry: float, extra: str = "") -> web.Response:
    token = f"mtpu-sts-{creds.access_key}"
    body = f"""<{action}Response xmlns="https://sts.amazonaws.com/doc/{STS_VERSION}/">
  <{action}Result>
    <Credentials>
      <AccessKeyId>{escape(creds.access_key)}</AccessKeyId>
      <SecretAccessKey>{escape(creds.secret_key)}</SecretAccessKey>
      <SessionToken>{escape(token)}</SessionToken>
      <Expiration>{_iso(expiry)}</Expiration>
    </Credentials>{extra}
  </{action}Result>
  <ResponseMetadata/>
</{action}Response>"""
    return web.Response(body=body.encode(), content_type="application/xml")


def _assume_role(iam: IAMSys, access_key: str, form: dict[str, str]) -> web.Response:
    if not access_key:
        raise S3Error("AccessDenied")
    creds, expiry = iam.new_sts_credentials(
        access_key, _duration(form), _session_policy(form)
    )
    return _creds_xml("AssumeRole", creds, expiry)


# -- OIDC (WebIdentity / ClientGrants) ---------------------------------------


def _openid_conf(config) -> dict:
    get = (lambda k: config.get("identity_openid", k)) if config is not None else (lambda k: "")
    return {
        "jwks": get("jwks"),
        "hmac_secret": get("hmac_secret"),
        "claim_name": get("claim_name") or "policy",
        "client_id": get("client_id"),
    }


def _assume_role_with_token(
    iam: IAMSys, config, form: dict[str, str], token: str, action: str
) -> web.Response:
    conf = _openid_conf(config)
    if not conf["jwks"] and not conf["hmac_secret"]:
        raise S3Error("NotImplemented", "OpenID identity is not configured")
    if not token:
        raise S3Error("InvalidRequest", "missing identity token")
    jwks = None
    if conf["jwks"]:
        try:
            jwks = json.loads(conf["jwks"])
        except ValueError:
            raise S3Error("InternalError", "bad JWKS configuration")
    try:
        claims = jwt_mod.verify(
            token,
            jwks=jwks,
            hmac_secret=conf["hmac_secret"],
            audience=conf["client_id"],
        )
    except jwt_mod.JWTError as e:
        raise S3Error("AccessDenied", f"invalid identity token: {e}")

    raw = claims.get(conf["claim_name"], "")
    policies = (
        [p.strip() for p in raw.split(",") if p.strip()]
        if isinstance(raw, str)
        else [str(p) for p in raw]
    )
    if not policies:
        raise S3Error(
            "AccessDenied", f"token lacks the {conf['claim_name']!r} policy claim"
        )
    # Token exp strictly bounds the credential lifetime (the reference caps
    # at the JWT expiry; credentials must never outlive the identity token).
    duration = _duration(form)
    if claims.get("exp") is not None:
        try:
            remaining = int(float(claims["exp"]) - time.time())
        except (TypeError, ValueError):
            raise S3Error("AccessDenied", "invalid exp claim in identity token")
        if remaining <= 0:
            raise S3Error("AccessDenied", "identity token expired")
        duration = min(duration, remaining)
    creds, expiry = iam.new_sts_credentials_for_policies(
        policies, duration, _session_policy(form)
    )
    subject = str(claims.get("sub", ""))
    extra = (
        f"\n    <SubjectFromWebIdentityToken>{escape(subject)}</SubjectFromWebIdentityToken>"
        if action == "AssumeRoleWithWebIdentity"
        else ""
    )
    return _creds_xml(action, creds, expiry, extra)


# -- LDAP identity ------------------------------------------------------------


def _assume_role_with_ldap(iam: IAMSys, config, form: dict[str, str]) -> web.Response:
    """AssumeRoleWithLDAPIdentity (cmd/sts-handlers.go:447): lookup-bind the
    username, verify the password with a user bind, map the user/group DNs
    through the IAM LDAP policy DB, and issue temp credentials."""
    from ..control import ldap as ldap_mod

    conf = ldap_mod.LDAPConfig.from_config(config)
    if not conf.server_addr:
        raise S3Error("NotImplemented", "LDAP identity is not configured")
    username = form.get("LDAPUsername", "")
    password = form.get("LDAPPassword", "")
    if not username or not password:
        raise S3Error("InvalidRequest", "LDAPUsername and LDAPPassword are required")
    try:
        user_dn, groups = ldap_mod.authenticate(conf, username, password)
    except ldap_mod.LDAPError as e:
        raise S3Error("AccessDenied", f"LDAP authentication failed: {e}")
    policies = iam.ldap_policies_for(user_dn, groups)
    if not policies:
        raise S3Error(
            "AccessDenied", f"no policy mapped for LDAP identity {user_dn!r}"
        )
    creds, expiry = iam.new_sts_credentials_for_policies(
        policies, _duration(form), _session_policy(form)
    )
    return _creds_xml("AssumeRoleWithLDAPIdentity", creds, expiry)


# -- mTLS certificate ---------------------------------------------------------


def _assume_role_with_certificate(
    iam: IAMSys, config, form: dict[str, str], request: web.Request | None
) -> web.Response:
    enabled = config is not None and config.get("identity_tls", "enable") == "on"
    if not enabled:
        raise S3Error("NotImplemented", "TLS identity is not configured")
    peercert = None
    if request is not None and request.transport is not None:
        peercert = request.transport.get_extra_info("peercert")
    if not peercert:
        raise S3Error(
            "InvalidRequest", "a client certificate is required (mTLS connection)"
        )
    # CN names the policy (sts-handlers.go AssumeRoleWithCertificate: the
    # certificate CN maps to the policy of the same name).
    cn = ""
    for rdn in peercert.get("subject", ()):  # ssl module cert dict shape
        for key, value in rdn:
            if key == "commonName":
                cn = value
    if not cn:
        raise S3Error("InvalidRequest", "client certificate has no CN")
    creds, expiry = iam.new_sts_credentials_for_policies([cn], _duration(form, 3600))
    return _creds_xml("AssumeRoleWithCertificate", creds, expiry)


def parse_form(body: bytes) -> dict[str, str]:
    return {k: v[0] for k, v in urllib.parse.parse_qs(body.decode()).items()}
