"""IAM subsystem: users, service accounts, policies, persistence.

Role of the reference's IAMSys (cmd/iam.go:62, iam-store.go): credential +
policy store with an in-memory cache, persisted under the system meta bucket
(.minio_tpu.sys/config/iam/) through the object layer so it survives restarts
and replicates with the cluster. STS temporary credentials layer on top
(api/sts.py).
"""

from __future__ import annotations

import contextlib
import json
import secrets
import threading
import time
from dataclasses import dataclass, field

from ..api.auth import Credentials
from ..utils import errors
from . import policy as policy_mod
from .sanitizer import san_lock, san_rlock

IAM_PREFIX = "config/iam"


@dataclass
class UserIdentity:
    credentials: Credentials
    status: str = "enabled"
    policies: list[str] = field(default_factory=list)
    groups: list[str] = field(default_factory=list)
    # Service accounts / STS creds:
    parent_user: str = ""
    session_policy: dict | None = None
    expiration: float = 0.0  # 0 = never

    def expired(self) -> bool:
        return self.expiration > 0 and time.time() > self.expiration

    def to_dict(self, with_secret: bool = True) -> dict:
        return {
            "accessKey": self.credentials.access_key,
            "secretKey": self.credentials.secret_key if with_secret else "",
            "status": self.status,
            "policies": self.policies,
            "groups": self.groups,
            "parentUser": self.parent_user,
            "sessionPolicy": self.session_policy,
            "expiration": self.expiration,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "UserIdentity":
        return cls(
            credentials=Credentials(d["accessKey"], d.get("secretKey", "")),
            status=d.get("status", "enabled"),
            policies=list(d.get("policies", [])),
            groups=list(d.get("groups", [])),
            parent_user=d.get("parentUser", ""),
            session_policy=d.get("sessionPolicy"),
            expiration=d.get("expiration", 0.0),
        )


class IAMSys:
    """In-memory IAM store with optional persistence via a store backend."""

    def __init__(self, root_user: str, root_password: str, store=None):
        self.root = Credentials(root_user, root_password)
        self.users: dict[str, UserIdentity] = {}
        # Groups (cmd/group-handlers.go role): name -> {"members": [ak],
        # "status": "enabled"|"disabled", "policies": [names]}. A user's
        # effective policy set unions every enabled group they belong to.
        self.groups: dict[str, dict] = {}
        self.custom_policies: dict[str, dict] = {}
        # LDAP policy DB: DN (user or group) -> policy names. The reference
        # keeps the same mapping in its IAM store (mc admin policy attach
        # --user 'uid=...'); LDAP identities have no local user records.
        self.ldap_policy_map: dict[str, list[str]] = {}
        self.store = store  # object-layer-backed persistence (control/configsys)
        # Optional cluster lock factory (dist NamespaceLock): when set,
        # persisted mutations serialize cluster-wide and refresh from the
        # store first, so two nodes mutating concurrently can't clobber
        # each other's whole-snapshot writes.
        self.ns_lock = None
        self._lock = san_rlock("IAMSys._lock")
        self._persist_lock = san_lock("IAMSys._persist_lock")
        # Serializes whole mutations AND reloads: a peer-triggered load()
        # landing between a mutation's in-memory apply and its persist
        # would reset state to the pre-mutation snapshot and the persist
        # would then write the change away.
        self._mutate_lock = san_rlock("IAMSys._mutate_lock")

    # -- persistence ---------------------------------------------------------

    _SEAL_MAGIC = b"MTPUIAM1"

    def _seal_key(self) -> bytes:
        # Keyed from the root credential, like the reference's
        # madmin-encrypted IAM blobs (iam-object-store.go loadIAMConfig):
        # drive access alone must not yield every long-lived secret key.
        import hashlib

        return hashlib.sha256(b"minio_tpu-iam-store:" + self.root.secret_key.encode()).digest()

    def _seal(self, data: bytes) -> bytes:
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError:
            # No cryptography available: persist plaintext (no magic prefix),
            # which _unseal reads back unchanged. Sealed-at-rest resumes as
            # soon as the library exists.
            return data

        nonce = secrets.token_bytes(12)
        ct = AESGCM(self._seal_key()).encrypt(nonce, data, b"iam")
        return self._SEAL_MAGIC + nonce + ct

    def _unseal(self, blob: bytes) -> bytes:
        if not blob.startswith(self._SEAL_MAGIC):
            return blob  # pre-encryption plaintext blob: readable once,
            # re-sealed on the next persist
        try:
            from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        except ImportError as e:
            raise errors.FileCorrupt(
                "IAM store is sealed but cryptography is not installed"
            ) from e

        try:
            return AESGCM(self._seal_key()).decrypt(
                blob[len(self._SEAL_MAGIC) : len(self._SEAL_MAGIC) + 12],
                blob[len(self._SEAL_MAGIC) + 12 :],
                b"iam",
            )
        except Exception as e:  # noqa: BLE001 - wrong root credential / corrupt
            raise errors.FileCorrupt(
                "IAM store unseal failed (root credentials changed?)"
            ) from e

    def _get_sealed(self, path: str) -> bytes | None:
        raw = self.store.get(path)
        return self._unseal(raw) if raw else None

    def load(self) -> None:
        """Refresh from the store. Unexpired TEMPORARY credentials (STS)
        are deliberately never persisted; a reload must merge them back in
        or every active federated session dies on any peer IAM reload."""
        if self.store is None:
            return
        with self._mutate_lock:
            self._load_locked()

    def _load_locked(self) -> None:
        raw = self._get_sealed(f"{IAM_PREFIX}/users.json")
        if raw:
            data = json.loads(raw)
            with self._lock:
                fresh = {k: UserIdentity.from_dict(v) for k, v in data.items()}
                for ak, ident in self.users.items():
                    if ak not in fresh and ident.expiration > 0 and not ident.expired():
                        fresh[ak] = ident
                self.users = fresh
        raw = self._get_sealed(f"{IAM_PREFIX}/policies.json")
        if raw:
            self.custom_policies = json.loads(raw)
        raw = self._get_sealed(f"{IAM_PREFIX}/ldap-policy-map.json")
        if raw:
            self.ldap_policy_map = json.loads(raw)
        raw = self._get_sealed(f"{IAM_PREFIX}/groups.json")
        if raw:
            self.groups = json.loads(raw)

    def _persist(self) -> None:
        if self.store is None:
            return
        # _persist_lock serializes whole persists so a stale snapshot can
        # never overwrite a newer one; _lock (held briefly inside) protects
        # the snapshot itself from concurrent mutation mid-serialization.
        # Temporary credentials stay memory-only (never written).
        with self._persist_lock:
            with self._lock:
                users = {
                    k: v.to_dict() for k, v in self.users.items() if v.expiration == 0
                }
                policies = json.dumps(self.custom_policies)
                ldap_map = json.dumps(self.ldap_policy_map)
                groups = json.dumps(self.groups)
            self.store.put(f"{IAM_PREFIX}/users.json", self._seal(json.dumps(users).encode()))
            self.store.put(f"{IAM_PREFIX}/policies.json", self._seal(policies.encode()))
            self.store.put(f"{IAM_PREFIX}/ldap-policy-map.json", self._seal(ldap_map.encode()))
            self.store.put(f"{IAM_PREFIX}/groups.json", self._seal(groups.encode()))

    @contextlib.contextmanager
    def _mutating(self):
        """Context for a persisted mutation: under the process mutation
        lock (so a peer-triggered reload can't reset state between apply
        and persist) and the cluster IAM lock (when wired), refreshing
        from the store first so a concurrent mutation on another node
        isn't clobbered by this node's whole-snapshot write."""
        with self._mutate_lock:
            lk = self.ns_lock.new(".minio_tpu.sys", "iam") if self.ns_lock is not None else None
            if lk is not None and not lk.acquire(writer=True, timeout=15):
                raise errors.ErasureWriteQuorum(".minio_tpu.sys", "iam lock timeout")
            try:
                # Refresh-before-apply whenever a store exists, locked or
                # not: a second writer sharing the store (another gateway
                # on the same etcd) would otherwise have every mutation
                # clobber the other's whole snapshot. Without a shared
                # lock the refresh shrinks the lost-update window to the
                # apply+persist span rather than eliminating it.
                if self.store is not None:
                    self._load_locked()
                yield
                self._persist()
            finally:
                if lk is not None:
                    lk.release()

    # -- groups (cmd/group-handlers.go: add/remove members, status, policy) --

    def update_group_members(self, group: str, members: list[str], remove: bool = False) -> None:
        """Add (or remove) members; adding creates the group (the
        reference's UpdateGroupMembers semantics). Validates the WHOLE
        member list before touching anything — a failure mid-apply would
        leave earlier members holding the group's policies in memory while
        the request reports an error."""
        with self._mutating(), self._lock:
            g = self.groups.get(group)
            if g is None and remove:
                raise errors.InvalidArgument(msg=f"no such group {group}")
            if not remove:
                missing = [ak for ak in members if ak not in self.users]
                if missing:
                    raise errors.InvalidArgument(msg=f"no such user(s) {missing}")
            if g is None:
                g = self.groups[group] = {"members": [], "status": "enabled", "policies": []}
            for ak in members:
                if remove:
                    if ak in g["members"]:
                        g["members"].remove(ak)
                    if ak in self.users and group in self.users[ak].groups:
                        self.users[ak].groups.remove(group)
                else:
                    if ak not in g["members"]:
                        g["members"].append(ak)
                    if group not in self.users[ak].groups:
                        self.users[ak].groups.append(group)

    def remove_group(self, group: str) -> None:
        with self._mutating(), self._lock:
            g = self.groups.get(group)
            if g is None:
                raise errors.InvalidArgument(msg=f"no such group {group}")
            if g["members"]:
                raise errors.InvalidArgument(
                    msg=f"group {group} is not empty; remove members first"
                )
            del self.groups[group]

    def set_group_status(self, group: str, status: str) -> None:
        with self._mutating(), self._lock:
            if group not in self.groups:
                raise errors.InvalidArgument(msg=f"no such group {group}")
            self.groups[group]["status"] = status

    def attach_group_policy(self, group: str, policy_names: list[str]) -> None:
        with self._mutating(), self._lock:
            if group not in self.groups:
                raise errors.InvalidArgument(msg=f"no such group {group}")
            self.groups[group]["policies"] = list(policy_names)

    def list_groups(self) -> list[str]:
        with self._lock:
            return sorted(self.groups)

    def group_info(self, group: str) -> dict:
        with self._lock:
            g = self.groups.get(group)
            if g is None:
                raise errors.InvalidArgument(msg=f"no such group {group}")
            return {"name": group, **{k: list(v) if isinstance(v, list) else v for k, v in g.items()}}

    def _group_policy_names(self, ident: UserIdentity) -> list[str]:
        """Policies inherited from the user's ENABLED groups."""
        out: list[str] = []
        with self._lock:
            for gname in ident.groups:
                g = self.groups.get(gname)
                if g is not None and g.get("status") == "enabled":
                    for p in g.get("policies", []):
                        if p not in out:
                            out.append(p)
        return out

    # -- LDAP policy mapping (sts-handlers.go LDAP policy lookup role) -------

    def set_ldap_policy(self, dn: str, policy_names: list[str]) -> None:
        with self._mutating(), self._lock:
            if policy_names:
                self.ldap_policy_map[dn] = list(policy_names)
            else:
                self.ldap_policy_map.pop(dn, None)

    def ldap_policies_for(self, user_dn: str, group_dns: list[str]) -> list[str]:
        """Union of policies attached to the user DN and its group DNs
        (DN keys are compared case-insensitively, as LDAP DNs are)."""
        with self._lock:
            lowered = {k.lower(): v for k, v in self.ldap_policy_map.items()}
        out: list[str] = []
        for dn in [user_dn, *group_dns]:
            for p in lowered.get(dn.lower(), []):
                if p not in out:
                    out.append(p)
        return out

    # -- credential lookup (hot path for SigV4) ------------------------------

    def lookup(self, access_key: str) -> Credentials | None:
        if access_key == self.root.access_key:
            return self.root
        with self._lock:
            ident = self.users.get(access_key)
        if ident is None or ident.status != "enabled" or ident.expired():
            return None
        return ident.credentials

    # -- user management (admin API surface) ---------------------------------

    def add_user(self, access_key: str, secret_key: str, policies: list[str] | None = None):
        with self._mutating(), self._lock:
            self.users[access_key] = UserIdentity(
                Credentials(access_key, secret_key), policies=policies or []
            )

    def remove_user(self, access_key: str) -> None:
        with self._mutating(), self._lock:
            if access_key not in self.users:
                raise errors.InvalidArgument(msg=f"no such user {access_key}")
            del self.users[access_key]
            # Cascade: service accounts and STS creds derived from this user
            # die with it, in the SAME persisted mutation -- an orphan child
            # credential would silently revive if the key is ever recreated.
            for child_ak in [
                ak for ak, ident in self.users.items()
                if ident.parent_user == access_key
            ]:
                del self.users[child_ak]
            for g in self.groups.values():
                if access_key in g["members"]:
                    g["members"].remove(access_key)

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._mutating(), self._lock:
            if access_key not in self.users:
                raise errors.InvalidArgument(msg=f"no such user {access_key}")
            self.users[access_key].status = status

    def list_users(self) -> dict[str, UserIdentity]:
        with self._lock:
            return dict(self.users)

    def attach_policy(self, access_key: str, policy_names: list[str]) -> None:
        with self._mutating(), self._lock:
            if access_key not in self.users:
                raise errors.InvalidArgument(msg=f"no such user {access_key}")
            self.users[access_key].policies = list(policy_names)

    def set_policy(self, name: str, doc: dict) -> None:
        with self._mutating():
            self.custom_policies[name] = doc

    def delete_policy(self, name: str) -> None:
        with self._mutating():
            self.custom_policies.pop(name, None)

    def new_service_account(
        self, parent: str, session_policy: dict | None = None
    ) -> Credentials:
        ak = "SA" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        with self._mutating(), self._lock:
            self.users[ak] = UserIdentity(
                Credentials(ak, sk), parent_user=parent, session_policy=session_policy
            )
        return Credentials(ak, sk)

    def new_sts_credentials_for_policies(
        self,
        policies: list[str],
        duration_seconds: int,
        session_policy: dict | None = None,
    ) -> tuple[Credentials, float]:
        """Temporary credentials for a federated identity (OIDC/LDAP/cert):
        no parent user — the mapped policies ARE the permission set
        (sts-handlers.go WithSSO/Certificate issuance)."""
        ak = "STS" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        exp = time.time() + duration_seconds
        with self._lock:
            self.users[ak] = UserIdentity(
                Credentials(ak, sk),
                policies=list(policies),
                session_policy=session_policy,
                expiration=exp,
            )
        return Credentials(ak, sk), exp

    def new_sts_credentials(
        self, parent: str, duration_seconds: int, session_policy: dict | None = None
    ) -> tuple[Credentials, float]:
        ak = "STS" + secrets.token_hex(8).upper()
        sk = secrets.token_urlsafe(30)
        exp = time.time() + duration_seconds
        with self._lock:
            self.users[ak] = UserIdentity(
                Credentials(ak, sk),
                parent_user=parent,
                session_policy=session_policy,
                expiration=exp,
            )
        return Credentials(ak, sk), exp

    # -- authorization -------------------------------------------------------

    def _policy_doc(self, name: str) -> dict | None:
        if name in self.custom_policies:
            return self.custom_policies[name]
        return policy_mod.CANNED.get(name)

    def is_allowed(
        self, access_key: str, action: str, resource: str, context: dict | None = None
    ) -> bool:
        """Policy evaluation (IAMSys.IsAllowed equivalent). `context` carries
        request condition keys (aws:SourceIp, s3:prefix, ...)."""
        if access_key == self.root.access_key:
            return True  # root owner bypasses policy, as in the reference
        with self._lock:
            ident = self.users.get(access_key)
        if ident is None or ident.status != "enabled" or ident.expired():
            return False
        names = list(ident.policies) + self._group_policy_names(ident)
        subject = ident
        # Service accounts / STS inherit the parent's policies (incl. the
        # parent's group-derived ones), optionally narrowed by a session
        # policy.
        if ident.parent_user:
            if ident.parent_user == self.root.access_key:
                parent_allowed = True
            else:
                with self._lock:
                    parent = self.users.get(ident.parent_user)
                if parent is None:
                    return False
                names = list(parent.policies) + self._group_policy_names(parent)
                parent_allowed = self._eval(names, action, resource, context)
            if ident.session_policy is not None:
                sp = policy_mod.Policy.from_dict(ident.session_policy)
                return parent_allowed and sp.is_allowed(action, resource, context)
            return parent_allowed
        allowed = self._eval(names, action, resource, context)
        # Federated STS identities (no parent user) carry mapped policies; a
        # session policy can only NARROW them, never broaden.
        if allowed and ident.session_policy is not None:
            sp = policy_mod.Policy.from_dict(ident.session_policy)
            return sp.is_allowed(action, resource, context)
        return allowed

    def _eval(
        self, names: list[str], action: str, resource: str, context: dict | None = None
    ) -> bool:
        for name in names:
            doc = self._policy_doc(name)
            if doc and policy_mod.Policy.from_dict(doc).is_allowed(action, resource, context):
                return True
        return False
