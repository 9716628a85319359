"""Minimal LDAP v3 client: simple bind + subtree search over raw BER.

Role of the reference's LDAP identity integration
(cmd/sts-handlers.go:447 AssumeRoleWithLDAPIdentity +
internal/config/identity/ldap): authenticate an LDAP username/password via
the lookup-bind flow — bind a service account, search the user's DN,
re-bind as that DN to verify the password, then search group memberships.

Zero-dependency in the house style of the event brokers
(control/event_targets.py): the LDAP wire protocol (RFC 4511) is BER-encoded
TLVs over TCP, and the handful of operations STS needs — BindRequest,
SearchRequest with equality/and/or/not/present filters, Unbind — fit in a
small hand-rolled codec. The BER helpers are module-level so the test
stub server speaks the same wire format from the other side.
"""

from __future__ import annotations

import socket
import ssl as ssl_mod
from dataclasses import dataclass, field


class LDAPError(Exception):
    pass


# -- BER (the subset LDAP v3 messages use) ----------------------------------

TAG_INT = 0x02
TAG_OCTET = 0x04
TAG_ENUM = 0x0A
TAG_SEQ = 0x30
TAG_SET = 0x31
APP_BIND_REQ = 0x60
APP_BIND_RESP = 0x61
APP_UNBIND = 0x42
APP_SEARCH_REQ = 0x63
APP_SEARCH_ENTRY = 0x64
APP_SEARCH_DONE = 0x65
APP_SEARCH_REF = 0x73  # SearchResultReference (referrals; AD returns these)
CTX_SIMPLE_AUTH = 0x80
FILTER_AND = 0xA0
FILTER_OR = 0xA1
FILTER_NOT = 0xA2
FILTER_EQ = 0xA3
FILTER_PRESENT = 0x87


def ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    out = b""
    while n:
        out = bytes([n & 0xFF]) + out
        n >>= 8
    return bytes([0x80 | len(out)]) + out


def tlv(tag: int, content: bytes) -> bytes:
    return bytes([tag]) + ber_len(len(content)) + content


def ber_int(v: int, tag: int = TAG_INT) -> bytes:
    out = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big", signed=True)
    return tlv(tag, out)


def ber_read(buf: bytes, pos: int = 0) -> tuple[int, bytes, int]:
    """-> (tag, content, next_pos); raises LDAPError on truncation."""
    if pos + 2 > len(buf):
        raise LDAPError("BER: truncated header")
    tag = buf[pos]
    length = buf[pos + 1]
    pos += 2
    if length & 0x80:
        n = length & 0x7F
        if n == 0 or n > 8 or pos + n > len(buf):
            raise LDAPError("BER: bad length")
        length = int.from_bytes(buf[pos : pos + n], "big")
        pos += n
    if pos + length > len(buf):
        raise LDAPError("BER: truncated value")
    return tag, buf[pos : pos + length], pos + length


def ber_read_int(content: bytes) -> int:
    return int.from_bytes(content, "big", signed=True)


# -- RFC 4515 filter strings -> BER filters ----------------------------------


def escape_filter_value(v: str) -> str:
    """Escape a value for substitution into a filter template (RFC 4515):
    user-controlled usernames must not inject filter structure."""
    out = []
    for ch in v:
        if ch in ("*", "(", ")", "\\", "\x00"):
            out.append(f"\\{ord(ch):02x}")
        else:
            out.append(ch)
    return "".join(out)


def escape_dn_value(v: str) -> str:
    """DNs substituted into group filters get the same value escaping."""
    return escape_filter_value(v)


def _unescape(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        if v[i] == "\\" and i + 3 <= len(v):
            try:
                out.append(chr(int(v[i + 1 : i + 3], 16)))
            except ValueError:
                raise LDAPError(f"filter: bad escape \\{v[i + 1 : i + 3]!r}")
            i += 3
        else:
            out.append(v[i])
            i += 1
    return "".join(out)


def compile_filter(s: str) -> bytes:
    flt, rest = _parse_filter(s.strip())
    if rest.strip():
        raise LDAPError(f"filter: trailing data {rest!r}")
    return flt


def _parse_filter(s: str) -> tuple[bytes, str]:
    if not s.startswith("("):
        raise LDAPError(f"filter: expected '(' at {s[:20]!r}")
    s = s[1:]
    if s[:1] in ("&", "|", "!"):
        op = s[0]
        s = s[1:]
        subs = []
        while s.startswith("("):
            sub, s = _parse_filter(s)
            subs.append(sub)
        if not s.startswith(")"):
            raise LDAPError("filter: unterminated composite")
        if op == "!" and len(subs) != 1:
            raise LDAPError("filter: NOT takes exactly one subfilter")
        tag = {"&": FILTER_AND, "|": FILTER_OR, "!": FILTER_NOT}[op]
        return tlv(tag, b"".join(subs)), s[1:]
    end = s.find(")")
    if end < 0:
        raise LDAPError("filter: unterminated item")
    item, rest = s[:end], s[end + 1 :]
    if "=" not in item:
        raise LDAPError(f"filter: no '=' in {item!r}")
    attr, value = item.split("=", 1)
    if value == "*":
        return tlv(FILTER_PRESENT, attr.encode()), rest
    if "*" in value:
        raise LDAPError("filter: substring matching not supported")
    return (
        tlv(
            FILTER_EQ,
            tlv(TAG_OCTET, attr.encode()) + tlv(TAG_OCTET, _unescape(value).encode()),
        ),
        rest,
    )


# -- client ------------------------------------------------------------------

SCOPE_BASE, SCOPE_ONE, SCOPE_SUBTREE = 0, 1, 2


class LDAPClient:
    """One LDAP connection: bind / search / unbind (RFC 4511 subset)."""

    def __init__(
        self,
        server_addr: str,
        use_tls: bool = False,
        tls_skip_verify: bool = False,
        timeout: float = 5.0,
    ):
        host, _, port = server_addr.rpartition(":")
        if not host:
            host, port = server_addr, "636" if use_tls else "389"
        try:
            portno = int(port.strip())
        except ValueError:
            raise LDAPError(f"bad server_addr {server_addr!r}")
        try:
            self._sock = socket.create_connection((host.strip(), portno), timeout=timeout)
        except OSError as e:
            raise LDAPError(f"connect {server_addr}: {e}") from e
        if use_tls:
            ctx = ssl_mod.create_default_context()
            if tls_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl_mod.CERT_NONE
            try:
                self._sock = ctx.wrap_socket(self._sock, server_hostname=host)
            except (OSError, ssl_mod.SSLError) as e:
                self._sock.close()
                raise LDAPError(f"TLS to {server_addr}: {e}") from e
        self._msg_id = 0
        self._buf = b""

    def close(self) -> None:
        try:
            self._msg_id += 1
            self._sock.sendall(
                tlv(TAG_SEQ, ber_int(self._msg_id) + tlv(APP_UNBIND, b""))
            )
        except OSError:
            pass
        finally:
            try:
                self._sock.close()
            except OSError:
                pass

    def _send(self, op: bytes) -> int:
        self._msg_id += 1
        self._sock.sendall(tlv(TAG_SEQ, ber_int(self._msg_id) + op))
        return self._msg_id

    def _recv_message(self) -> tuple[int, int, bytes]:
        """-> (message_id, op_tag, op_content)."""
        while True:
            try:
                tag, content, nxt = ber_read(self._buf)
                self._buf = self._buf[nxt:]
                break
            except LDAPError:
                try:
                    chunk = self._sock.recv(65536)
                except OSError as e:
                    raise LDAPError(f"recv: {e}") from e
                if not chunk:
                    raise LDAPError("connection closed by server")
                self._buf += chunk
        if tag != TAG_SEQ:
            raise LDAPError(f"unexpected message tag 0x{tag:02x}")
        t, mid_raw, pos = ber_read(content)
        if t != TAG_INT:
            raise LDAPError("message without id")
        op_tag, op_content, _ = ber_read(content, pos)
        return ber_read_int(mid_raw), op_tag, op_content

    @staticmethod
    def _result(content: bytes) -> tuple[int, str]:
        t, code_raw, pos = ber_read(content)
        _, _matched, pos = ber_read(content, pos)
        _, diag, _ = ber_read(content, pos)
        return ber_read_int(code_raw), diag.decode("utf-8", "replace")

    def bind(self, dn: str, password: str) -> None:
        op = tlv(
            APP_BIND_REQ,
            ber_int(3)
            + tlv(TAG_OCTET, dn.encode())
            + tlv(CTX_SIMPLE_AUTH, password.encode()),
        )
        mid = self._send(op)
        rmid, op_tag, content = self._recv_message()
        if rmid != mid or op_tag != APP_BIND_RESP:
            raise LDAPError("protocol: expected BindResponse")
        code, diag = self._result(content)
        if code != 0:
            raise LDAPError(f"bind failed (code {code}): {diag or dn}")

    def search(
        self,
        base_dn: str,
        filter_str: str,
        attributes: list[str] | None = None,
        scope: int = SCOPE_SUBTREE,
    ) -> list[tuple[str, dict[str, list[bytes]]]]:
        attrs = b"".join(tlv(TAG_OCTET, a.encode()) for a in (attributes or []))
        op = tlv(
            APP_SEARCH_REQ,
            tlv(TAG_OCTET, base_dn.encode())
            + ber_int(scope, TAG_ENUM)
            + ber_int(0, TAG_ENUM)  # neverDerefAliases
            + ber_int(0)  # sizeLimit
            + ber_int(0)  # timeLimit
            + tlv(0x01, b"\x00")  # typesOnly FALSE
            + compile_filter(filter_str)
            + tlv(TAG_SEQ, attrs),
        )
        mid = self._send(op)
        entries: list[tuple[str, dict[str, list[bytes]]]] = []
        while True:
            rmid, op_tag, content = self._recv_message()
            if rmid != mid:
                raise LDAPError("protocol: interleaved response")
            if op_tag == APP_SEARCH_ENTRY:
                _, dn_raw, pos = ber_read(content)
                _, attr_seq, _ = ber_read(content, pos)
                attrs_out: dict[str, list[bytes]] = {}
                apos = 0
                while apos < len(attr_seq):
                    _, one, apos = ber_read(attr_seq, apos)
                    _, name_raw, vpos = ber_read(one)
                    _, vals_set, _ = ber_read(one, vpos)
                    vals, spos = [], 0
                    while spos < len(vals_set):
                        _, v, spos = ber_read(vals_set, spos)
                        vals.append(v)
                    attrs_out[name_raw.decode()] = vals
                entries.append((dn_raw.decode(), attrs_out))
            elif op_tag == APP_SEARCH_DONE:
                code, diag = self._result(content)
                if code != 0:
                    raise LDAPError(f"search failed (code {code}): {diag}")
                return entries
            elif op_tag == APP_SEARCH_REF:
                continue  # referrals are not chased; AD sends them routinely
            else:
                raise LDAPError(f"protocol: unexpected op 0x{op_tag:02x}")


# -- the STS lookup-bind flow -------------------------------------------------


@dataclass
class LDAPConfig:
    """identity_ldap subsystem keys (internal/config/identity/ldap names)."""

    server_addr: str = ""
    lookup_bind_dn: str = ""
    lookup_bind_password: str = ""
    user_dn_search_base_dn: str = ""
    user_dn_search_filter: str = "(uid=%s)"
    group_search_base_dn: str = ""
    group_search_filter: str = ""
    tls: bool = False
    tls_skip_verify: bool = False
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_config(cls, config) -> "LDAPConfig":
        if config is None:
            return cls()

        def get(k: str) -> str:
            try:
                return config.get("identity_ldap", k) or ""
            except Exception:  # noqa: BLE001 - unregistered key reads as unset
                return ""
        return cls(
            server_addr=get("server_addr"),
            lookup_bind_dn=get("lookup_bind_dn"),
            lookup_bind_password=get("lookup_bind_password"),
            user_dn_search_base_dn=get("user_dn_search_base_dn"),
            user_dn_search_filter=get("user_dn_search_filter") or "(uid=%s)",
            group_search_base_dn=get("group_search_base_dn"),
            group_search_filter=get("group_search_filter"),
            tls=get("server_addr").startswith("ldaps://")
            or (get("tls") or "").lower() in ("on", "true", "1"),
            tls_skip_verify=(get("tls_skip_verify") or "").lower() in ("on", "true", "1"),
        )

    @property
    def addr(self) -> str:
        a = self.server_addr
        for prefix in ("ldaps://", "ldap://"):
            if a.startswith(prefix):
                a = a[len(prefix) :]
        return a


def authenticate(conf: LDAPConfig, username: str, password: str) -> tuple[str, list[str]]:
    """Lookup-bind: -> (user_dn, group_dns); raises LDAPError on any failure.

    An empty password is rejected up front: RFC 4513 treats a simple bind
    with an empty password as ANONYMOUS and succeeding — the classic LDAP
    authentication bypass.
    """
    if not password:
        raise LDAPError("empty password")
    lookup = LDAPClient(conf.addr, conf.tls, conf.tls_skip_verify)
    try:
        lookup.bind(conf.lookup_bind_dn, conf.lookup_bind_password)
        flt = conf.user_dn_search_filter.replace("%s", escape_filter_value(username))
        # "1.1" = noAttributes (RFC 4511): only the DN is used, so don't
        # pull AD-sized attribute sets (jpegPhoto, huge member lists).
        entries = lookup.search(conf.user_dn_search_base_dn, flt, ["1.1"])
        if not entries:
            raise LDAPError(f"user {username!r} not found")
        if len(entries) > 1:
            raise LDAPError(f"user filter matched {len(entries)} entries")
        user_dn = entries[0][0]
        # Verify the password on a SEPARATE connection: re-binding the
        # lookup connection would leave it authorized as the user.
        verify = LDAPClient(conf.addr, conf.tls, conf.tls_skip_verify)
        try:
            verify.bind(user_dn, password)
        finally:
            verify.close()
        groups: list[str] = []
        if conf.group_search_filter and conf.group_search_base_dn:
            gflt = conf.group_search_filter.replace(
                "%d", escape_dn_value(user_dn)
            ).replace("%s", escape_filter_value(username))
            groups = [
                dn for dn, _ in lookup.search(conf.group_search_base_dn, gflt, ["1.1"])
            ]
        return user_dn, groups
    finally:
        lookup.close()
