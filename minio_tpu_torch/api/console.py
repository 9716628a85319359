"""Embedded web console: the minio/console role, self-contained.

The reference embeds the external `minio/console` React app on a separate
port (cmd/common-main.go:197 initConsoleServer). This build serves a single
self-contained page plus a small JSON API under the reserved /mtpu prefix
(same port; "mtpu" is a reserved namespace like the reference's "minio"
bucket), covering the operator surface: login, cluster info, per-bucket
usage, object browsing, and a Prometheus snapshot. Everything else is the
admin REST's job (api/admin.py).

Auth: POST /mtpu/console/api/login with root or admin:*-allowed
credentials returns an HS256 JWT (signed with the root secret, 12 h
expiry; verified with api/jwt.verify); API calls carry it as a Bearer
token. The page renders all server-supplied strings through DOM
textContent -- object keys are attacker-controlled and must never reach
innerHTML.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import time

from aiohttp import web

from ..control.logging import GLOBAL_LOGGER
from ..utils import errors as oerr
from .jwt import JWTError, sign_hs256, verify as jwt_verify
from .server import _display_size

CONSOLE_PREFIX = "/mtpu/console"
TOKEN_TTL_S = 12 * 3600


def make_console_app(ctx) -> web.Application:
    """ctx: the admin context (iam, layer, metrics, node back-reference)."""
    app = web.Application()

    def _ready() -> None:
        if not getattr(ctx, "ready", True):
            raise web.HTTPServiceUnavailable(text="server initializing")

    def _secret() -> str:
        return ctx.iam.root.secret_key

    def _authed(request: web.Request) -> str:
        _ready()
        auth = request.headers.get("Authorization", "")
        if not auth.startswith("Bearer "):
            raise web.HTTPUnauthorized(text="missing bearer token")
        try:
            payload = jwt_verify(auth[7:], hmac_secret=_secret())
        except JWTError as e:
            raise web.HTTPUnauthorized(text=str(e)) from None
        ak = payload.get("sub", "")
        # Re-check the principal on EVERY call: a deleted/disabled admin's
        # token must die with the account, not live out its 12h expiry.
        if ak != ctx.iam.root.access_key and (
            ctx.iam.lookup(ak) is None
            or not ctx.iam.is_allowed(ak, "admin:*", "arn:aws:s3:::*")
        ):
            raise web.HTTPUnauthorized(text="account no longer authorized")
        return ak

    def _json(data, status=200) -> web.Response:
        return web.json_response(data, status=status)

    async def login(request: web.Request) -> web.Response:
        _ready()
        try:
            doc = await _body(request)
        except web.HTTPBadRequest:
            return _json({"error": "bad json"}, 400)
        ak = doc.get("accessKey", "")
        sk = doc.get("secretKey", "")
        if not isinstance(ak, str) or not isinstance(sk, str):
            return _json({"error": "invalid credentials"}, 401)
        creds = ctx.iam.lookup(ak)
        try:
            ok = creds is not None and hmac.compare_digest(
                creds.secret_key.encode(), sk.encode()
            )
        except (TypeError, UnicodeError):
            ok = False
        if not ok:
            return _json({"error": "invalid credentials"}, 401)
        if ak != ctx.iam.root.access_key and not ctx.iam.is_allowed(
            ak, "admin:*", "arn:aws:s3:::*"
        ):
            return _json({"error": "console requires admin privileges"}, 403)
        token = sign_hs256({"sub": ak, "exp": int(time.time()) + TOKEN_TTL_S}, _secret())
        return _json({"token": token})

    def _usage_summary() -> dict:
        scanner = getattr(ctx, "scanner", None)
        if scanner is not None and getattr(scanner, "usage", None) is not None:
            try:
                return scanner.usage.summary()
            except Exception as e:  # noqa: BLE001 - usage is advisory
                GLOBAL_LOGGER.log_once(f"usage summary unavailable: {e}", key="console-usage")
        return {}

    async def info(request: web.Request) -> web.Response:
        _authed(request)

        def work():
            layer = ctx.layer
            pools = getattr(layer, "pools", [])
            drives_total = drives_online = sets = 0
            for p in pools:
                for s in getattr(p, "sets", []):
                    sets += 1
                    for d in s.disks:
                        drives_total += 1
                        if d is not None and d.is_online():
                            drives_online += 1
            return {
                "pools": len(pools),
                "sets": sets,
                "drivesTotal": drives_total,
                "drivesOnline": drives_online,
                "usage": _usage_summary(),
            }

        return _json(await asyncio.to_thread(work))

    async def buckets(request: web.Request) -> web.Response:
        _authed(request)

        def work():
            usage = _usage_summary().get("bucketsUsage", {})
            out = []
            for b in ctx.layer.list_buckets():
                u = usage.get(b.name, {})
                out.append(
                    {
                        "name": b.name,
                        "created": b.created,
                        "objects": u.get("objectsCount", None),
                        "size": u.get("size", None),
                    }
                )
            return {"buckets": out}

        return _json(await asyncio.to_thread(work))

    async def objects(request: web.Request) -> web.Response:
        _authed(request)
        q = request.rel_url.query
        bucket = q.get("bucket", "")
        if not bucket:
            return _json({"error": "bucket required"}, 400)
        try:
            max_keys = int(q.get("max-keys", "100"))
        except ValueError:
            return _json({"error": "bad max-keys"}, 400)

        def work():
            return ctx.layer.list_objects(
                bucket,
                prefix=q.get("prefix", ""),
                marker=q.get("marker", ""),
                delimiter=q.get("delimiter", "/"),
                max_keys=max_keys,
            )

        try:
            res = await asyncio.to_thread(work)
        except (oerr.BucketNotFound, oerr.BucketNameInvalid) as e:
            return _json({"error": str(e)}, 404)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 400)
        return _json(
            {
                "objects": [
                    {"name": o.name, "size": _display_size(o), "modTime": o.mod_time, "etag": o.etag}
                    for o in res.objects
                ],
                "prefixes": res.prefixes,
                "truncated": res.is_truncated,
                "nextMarker": res.next_marker,
            }
        )

    async def metrics(request: web.Request) -> web.Response:
        _authed(request)
        m = getattr(ctx, "metrics", None)
        text = await asyncio.to_thread(m.render) if m is not None else ""
        return web.Response(text=text, content_type="text/plain")

    # -- management actions (the minio/console mutation surface: bucket,
    # user, service-account CRUD and policy attach). These run the SAME
    # post-mutation fan-out as the admin REST / S3 paths — peer IAM reload
    # and site replication — or multi-node state diverges. -----------------

    async def _body(request: web.Request) -> dict:
        try:
            doc = json.loads(await request.read() or b"{}")
        except ValueError:
            raise web.HTTPBadRequest(text="bad json")
        if not isinstance(doc, dict):
            raise web.HTTPBadRequest(text="bad json")
        return doc

    def _policies_field(doc: dict) -> list[str]:
        policies = doc.get("policies", [])
        if not isinstance(policies, list) or not all(
            isinstance(p, str) for p in policies
        ):
            # A bare string would iterate per-character into nonsense
            # policy names and "succeed" while denying everything.
            raise web.HTTPBadRequest(text="policies must be a list of names")
        return policies

    def _iam_fanout(kind: str, payload: dict) -> None:
        notification = getattr(ctx, "notification", None)
        if notification is not None:
            notification.reload_iam_all()
        site = getattr(ctx, "site_repl", None)
        if site is not None and getattr(site, "enabled", False):
            site.on_iam(kind, payload)

    async def bucket_create(request: web.Request) -> web.Response:
        _authed(request)
        doc = await _body(request)
        name = doc.get("name", "")
        if not isinstance(name, str) or not name:
            return _json({"error": "name required"}, 400)

        def work():
            ctx.layer.make_bucket(name)
            # Same hooks as the S3 PUT-bucket path (server.py _make_bucket):
            # seed bucket metadata and fan out to site replication.
            bm = getattr(ctx, "bucket_meta", None)
            if bm is not None:
                bm.save(bm.get(name))
            site = getattr(ctx, "site_repl", None)
            if site is not None and getattr(site, "enabled", False):
                site.on_bucket_make(name)

        try:
            await asyncio.to_thread(work)
        except (oerr.BucketExists,):
            return _json({"error": f"bucket {name!r} exists"}, 409)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 400)
        return _json({"ok": True})

    async def bucket_delete(request: web.Request) -> web.Response:
        _authed(request)
        name = request.rel_url.query.get("name", "")
        if not name:
            return _json({"error": "name required"}, 400)

        def work():
            from .server import delete_bucket_with_hooks

            delete_bucket_with_hooks(
                ctx.layer, name,
                bucket_meta=getattr(ctx, "bucket_meta", None),
                notification=getattr(ctx, "notification", None),
                site_repl=getattr(ctx, "site_repl", None),
                notifier=getattr(ctx, "notifier", None),
            )

        try:
            await asyncio.to_thread(work)
        except oerr.BucketNotEmpty:
            return _json({"error": "bucket not empty"}, 409)
        except oerr.BucketNotFound:
            return _json({"error": "no such bucket"}, 404)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 400)
        return _json({"ok": True})

    async def users_list(request: web.Request) -> web.Response:
        _authed(request)
        out = []
        for ak, ident in sorted(ctx.iam.list_users().items()):
            d = ident.to_dict(with_secret=False)
            d.pop("sessionPolicy", None)
            out.append(d)
        return _json({"users": out})

    async def user_create(request: web.Request) -> web.Response:
        _authed(request)
        doc = await _body(request)
        ak, sk = doc.get("accessKey", ""), doc.get("secretKey", "")
        if not ak or not sk or not isinstance(ak, str) or not isinstance(sk, str):
            return _json({"error": "accessKey and secretKey required"}, 400)
        if ak == ctx.iam.root.access_key:
            return _json({"error": "cannot overwrite the root account"}, 403)
        policies = _policies_field(doc)

        def work():
            ctx.iam.add_user(ak, sk, policies)
            _iam_fanout("user", ctx.iam.users[ak].to_dict())

        await asyncio.to_thread(work)
        return _json({"ok": True})

    async def user_delete(request: web.Request) -> web.Response:
        _authed(request)
        ak = request.rel_url.query.get("accessKey", "")

        def work():
            # remove_user cascades to the user's service accounts / STS
            # creds inside one persisted mutation; one fanout reloads the
            # whole IAM store on every peer.
            ctx.iam.remove_user(ak)
            _iam_fanout("user-delete", {"access_key": ak})

        try:
            await asyncio.to_thread(work)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 404)
        return _json({"ok": True})

    async def user_policy(request: web.Request) -> web.Response:
        _authed(request)
        doc = await _body(request)
        ak = doc.get("accessKey", "")
        policies = _policies_field(doc)

        def work():
            ctx.iam.attach_policy(ak, policies)
            _iam_fanout("policy-mapping", {"access_key": ak, "policies": policies})

        try:
            await asyncio.to_thread(work)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 404)
        return _json({"ok": True})

    async def sa_create(request: web.Request) -> web.Response:
        ak = _authed(request)
        doc = await _body(request)
        parent = doc.get("parent", "") or ak

        def work():
            creds = ctx.iam.new_service_account(parent)
            _iam_fanout("user", ctx.iam.users[creds.access_key].to_dict())
            return creds

        creds = await asyncio.to_thread(work)
        # The secret is shown ONCE at creation, as in the reference console.
        return _json({"accessKey": creds.access_key, "secretKey": creds.secret_key})

    async def policies_list(request: web.Request) -> web.Response:
        _authed(request)
        from ..control import policy as policy_mod

        names = sorted({*policy_mod.CANNED, *ctx.iam.custom_policies})
        return _json({"policies": names})

    async def groups_list(request: web.Request) -> web.Response:
        _authed(request)
        out = []
        for g in ctx.iam.list_groups():
            try:
                out.append(ctx.iam.group_info(g))
            except oerr.StorageError:
                continue  # deleted between snapshot and info: skip, not 500
        return _json({"groups": out})

    async def group_update(request: web.Request) -> web.Response:
        # Members add/remove (creates on first add) + policy attach, the
        # console face of the admin /groups handlers. Every field validates
        # BEFORE any mutation: a bad later field must not leave an earlier
        # one half-applied with the peer fanout skipped.
        _authed(request)
        doc = await _body(request)
        name = doc.get("name", "")
        if not isinstance(name, str) or not name:
            return _json({"error": "name required"}, 400)
        members = None
        if "members" in doc:
            members = doc.get("members", [])
            if not isinstance(members, list) or not all(
                isinstance(m, str) for m in members
            ):
                return _json({"error": "members must be a list of strings"}, 400)
        is_remove = doc.get("isRemove", False)
        if not isinstance(is_remove, bool):
            # bool("false") is True: a stringly-typed flag would silently
            # flip an add into a removal.
            return _json({"error": "isRemove must be a boolean"}, 400)
        policies = _policies_field(doc) if "policies" in doc else None
        status = None
        if "status" in doc:
            status = doc["status"]
            if status not in ("enabled", "disabled"):
                # Anything else persists and silently disables the group's
                # grants (only the exact string 'enabled' confers policies).
                return _json({"error": "status must be enabled|disabled"}, 400)
        if members is None and policies is None and status is None:
            return _json({"error": "nothing to change (members/policies/status)"}, 400)

        def work():
            if members is not None:
                ctx.iam.update_group_members(name, members, remove=is_remove)
            if policies is not None:
                ctx.iam.attach_group_policy(name, policies)
            if status is not None:
                ctx.iam.set_group_status(name, status)
            _iam_fanout("group", ctx.iam.group_info(name))

        try:
            await asyncio.to_thread(work)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 400)
        return _json({"ok": True})

    async def group_delete(request: web.Request) -> web.Response:
        _authed(request)
        name = request.rel_url.query.get("name", "")

        def work():
            ctx.iam.remove_group(name)
            _iam_fanout("group-delete", {"name": name})

        try:
            await asyncio.to_thread(work)
        except oerr.StorageError as e:
            return _json({"error": str(e)}, 400)
        return _json({"ok": True})

    async def index(request: web.Request) -> web.Response:
        return web.Response(text=_PAGE, content_type="text/html")

    app.router.add_post("/api/login", login)
    app.router.add_get("/api/info", info)
    app.router.add_get("/api/buckets", buckets)
    app.router.add_get("/api/objects", objects)
    app.router.add_get("/api/metrics", metrics)
    app.router.add_post("/api/buckets", bucket_create)
    app.router.add_delete("/api/buckets", bucket_delete)
    app.router.add_get("/api/users", users_list)
    app.router.add_post("/api/users", user_create)
    app.router.add_delete("/api/users", user_delete)
    app.router.add_put("/api/users/policy", user_policy)
    app.router.add_post("/api/service-accounts", sa_create)
    app.router.add_get("/api/policies", policies_list)
    app.router.add_get("/api/groups", groups_list)
    app.router.add_post("/api/groups", group_update)
    app.router.add_delete("/api/groups", group_delete)
    app.router.add_get("", index)
    app.router.add_get("/", index)
    return app


# The page builds every data-driven node with document.createElement +
# textContent (never innerHTML) -- bucket names and object keys are
# user-controlled input.
_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>minio_tpu console</title>
<style>
 :root { color-scheme: dark; }
 body { font: 14px/1.5 system-ui, sans-serif; margin: 0; background: #101418; color: #dde3ea; }
 header { padding: 14px 24px; background: #161c24; border-bottom: 1px solid #232b36;
          display: flex; align-items: baseline; gap: 12px; }
 header h1 { font-size: 16px; margin: 0; } header span { color: #7c8a9c; font-size: 12px; }
 main { padding: 24px; max-width: 1080px; margin: auto; }
 .cards { display: flex; gap: 16px; flex-wrap: wrap; margin-bottom: 24px; }
 .card { background: #161c24; border: 1px solid #232b36; border-radius: 8px;
         padding: 14px 20px; min-width: 130px; }
 .card b { display: block; font-size: 22px; } .card span { color: #7c8a9c; font-size: 12px; }
 table { width: 100%; border-collapse: collapse; background: #161c24;
         border: 1px solid #232b36; border-radius: 8px; }
 th, td { text-align: left; padding: 8px 14px; border-bottom: 1px solid #1d2530; }
 th { color: #7c8a9c; font-weight: 500; font-size: 12px; }
 tr:hover td { background: #1a2129; } a { color: #62b0ff; cursor: pointer; text-decoration: none; }
 #login { max-width: 320px; margin: 12vh auto; background: #161c24; padding: 28px;
          border-radius: 10px; border: 1px solid #232b36; }
 input { width: 100%; box-sizing: border-box; margin: 6px 0; padding: 9px 10px;
         background: #0d1116; color: #dde3ea; border: 1px solid #2a3442; border-radius: 6px; }
 button { margin-top: 10px; width: 100%; padding: 9px; background: #2463eb; color: white;
          border: 0; border-radius: 6px; cursor: pointer; font-size: 14px; }
 .err { color: #ff7a7a; font-size: 13px; min-height: 18px; }
 .crumbs { margin: 12px 0; color: #7c8a9c; } .hide { display: none; }
</style></head><body>
<header><h1>minio_tpu</h1><span>console</span>
 <nav id="nav" class="hide" style="margin-left:24px">
  <a id="nav-b">buckets</a> &nbsp; <a id="nav-u">users</a> &nbsp;
  <a id="nav-g">groups</a> &nbsp; <a id="nav-p">policies</a>
 </nav>
 <span style="margin-left:auto"><a id="logout" class="hide">sign out</a></span></header>
<main>
 <div id="login"><h3>Sign in</h3>
  <input id="ak" placeholder="access key" autocomplete="username">
  <input id="sk" placeholder="secret key" type="password" autocomplete="current-password">
  <div class="err" id="lerr"></div><button id="go">Sign in</button></div>
 <div id="dash" class="hide">
  <div class="cards" id="cards"></div>
  <div class="crumbs" id="crumbs"></div>
  <div id="actions"></div>
  <div class="err" id="aerr"></div>
  <table id="tbl"><thead></thead><tbody></tbody></table>
 </div>
</main><script>
const $ = q => document.querySelector(q);
let tok = sessionStorage.getItem('tok') || '';
const api = async (p, opt = {}) => {
  opt.headers = Object.assign({Authorization: 'Bearer ' + tok}, opt.headers || {});
  const r = await fetch('/mtpu/console/api' + p, opt);
  if (r.status === 401) { out(); throw 0; }
  return r;
};
function out() {
  tok = ''; sessionStorage.removeItem('tok');
  $('#login').classList.remove('hide'); $('#dash').classList.add('hide');
  $('#logout').classList.add('hide'); $('#nav').classList.add('hide');
}
$('#logout').onclick = out;
$('#go').onclick = async () => {
  const r = await fetch('/mtpu/console/api/login', {method: 'POST',
    body: JSON.stringify({accessKey: $('#ak').value, secretKey: $('#sk').value})});
  let d = {};
  try { d = await r.json(); }
  catch { $('#lerr').textContent = 'server error (' + r.status + ')'; return; }
  if (!r.ok) { $('#lerr').textContent = d.error || 'login failed'; return; }
  tok = d.token; sessionStorage.setItem('tok', tok); boot();
};
const fmt = n => n == null ? '\\u2013' :
  n >= 1<<30 ? (n/(1<<30)).toFixed(1)+' GiB' : n >= 1<<20 ? (n/(1<<20)).toFixed(1)+' MiB' :
  n >= 1024 ? (n/1024).toFixed(1)+' KiB' : n + ' B';
// DOM builders: every data string lands in textContent, never markup.
const el = (tag, text, onclick) => {
  const e = document.createElement(tag);
  if (text != null) e.textContent = text;
  if (onclick) { e.addEventListener('click', onclick); }
  return e;
};
const row = cells => {
  const tr = document.createElement('tr');
  for (const c of cells) { const td = document.createElement('td');
    td.append(c instanceof Node ? c : el('span', c)); tr.append(td); }
  return tr;
};
const head = cols => {
  const tr = document.createElement('tr');
  for (const c of cols) tr.append(el('th', c));
  $('#tbl thead').replaceChildren(tr);
  $('#tbl tbody').replaceChildren();
};
// Mutations report failures in #aerr; the acting view refreshes after.
const act = async (method, p, body) => {
  $('#aerr').textContent = '';
  const r = await api(p, {method, body: body == null ? undefined : JSON.stringify(body)});
  let d = {};
  try { d = await r.json(); } catch {}
  if (!r.ok) { $('#aerr').textContent = d.error || ('failed (' + r.status + ')'); throw 0; }
  return d;
};
const input = (ph, type) => {
  const i = el('input'); i.placeholder = ph; if (type) i.type = type;
  i.style.width = '180px'; i.style.margin = '0 8px 0 0'; return i;
};
const btn = (label, onclick) => {
  const b = el('button', label, onclick);
  b.style.width = 'auto'; b.style.marginTop = '0'; b.style.padding = '7px 14px'; return b;
};
async function boot() {
  $('#login').classList.add('hide'); $('#dash').classList.remove('hide');
  $('#logout').classList.remove('hide'); $('#nav').classList.remove('hide');
  const i = await (await api('/info')).json();
  const cards = [['pools', i.pools], ['sets', i.sets], ['drives online', i.drivesOnline],
    ['drives total', i.drivesTotal], ['objects', i.usage.objectsCount ?? '\\u2013'],
    ['data', fmt(i.usage.objectsTotalSize)]];
  $('#cards').replaceChildren(...cards.map(([k, v]) => {
    const c = el('div'); c.className = 'card'; c.append(el('b', v), el('span', k)); return c;
  }));
  showBuckets();
}
$('#nav-b').onclick = () => showBuckets();
$('#nav-u').onclick = () => showUsers();
$('#nav-g').onclick = () => showGroups();
$('#nav-p').onclick = () => showPolicies();
async function showBuckets() {
  $('#crumbs').replaceChildren(el('a', 'buckets', showBuckets));
  const name = input('new bucket name');
  $('#actions').replaceChildren(name,
    btn('create bucket', async () => {
      await act('POST', '/buckets', {name: name.value}); showBuckets();
    }));
  const d = await (await api('/buckets')).json();
  head(['bucket', 'objects', 'size', '']);
  const body = $('#tbl tbody');
  if (!d.buckets.length) body.append(row(['no buckets', '', '', '']));
  for (const b of d.buckets)
    body.append(row([el('a', b.name, () => showObjs(b.name, '')),
      b.objects ?? '\\u2013', fmt(b.size),
      el('a', 'delete', async () => {
        if (!confirm('Delete bucket ' + b.name + '?')) return;
        await act('DELETE', '/buckets?' + new URLSearchParams({name: b.name}));
        showBuckets();
      })]));
}
async function showUsers() {
  $('#crumbs').replaceChildren(el('b', 'users'));
  const ak = input('access key'), sk = input('secret key', 'password'),
        pol = input('policies (comma-sep)');
  $('#actions').replaceChildren(ak, sk, pol,
    btn('create user', async () => {
      await act('POST', '/users', {accessKey: ak.value, secretKey: sk.value,
        policies: pol.value.split(',').map(s => s.trim()).filter(Boolean)});
      showUsers();
    }));
  const d = await (await api('/users')).json();
  head(['access key', 'status', 'policies', 'parent', '']);
  const body = $('#tbl tbody');
  if (!d.users.length) body.append(row(['no users', '', '', '', '']));
  for (const u of d.users) {
    const actions = el('span');
    actions.append(
      el('a', 'attach policy', async () => {
        const p = prompt('Policies for ' + u.accessKey + ' (comma-sep):',
          u.policies.join(','));
        if (p == null) return;
        await act('PUT', '/users/policy', {accessKey: u.accessKey,
          policies: p.split(',').map(s => s.trim()).filter(Boolean)});
        showUsers();
      }),
      el('span', ' \\u00b7 '),
      el('a', 'svc acct', async () => {
        const c = await act('POST', '/service-accounts', {parent: u.accessKey});
        // shown once; the secret is not retrievable later
        prompt('Service account created \\u2014 copy these now:',
          c.accessKey + ' / ' + c.secretKey);
      }),
      el('span', ' \\u00b7 '),
      el('a', 'delete', async () => {
        if (!confirm('Delete user ' + u.accessKey + '?')) return;
        await act('DELETE', '/users?' + new URLSearchParams({accessKey: u.accessKey}));
        showUsers();
      }));
    body.append(row([u.accessKey, u.status, u.policies.join(', ') || '\\u2013',
      u.parentUser || '\\u2013', actions]));
  }
}
async function showGroups() {
  $('#crumbs').replaceChildren(el('b', 'groups'));
  const gn = input('group name'), gm = input('members (comma-sep)');
  $('#actions').replaceChildren(gn, gm,
    btn('add members', async () => {
      await act('POST', '/groups', {name: gn.value,
        members: gm.value.split(',').map(s => s.trim()).filter(Boolean)});
      showGroups();
    }));
  const d = await (await api('/groups')).json();
  head(['group', 'status', 'members', 'policies', '']);
  const body = $('#tbl tbody');
  if (!d.groups.length) body.append(row(['no groups', '', '', '', '']));
  for (const g of d.groups) {
    const actions = el('span');
    actions.append(
      el('a', 'policies', async () => {
        const p = prompt('Policies for ' + g.name + ' (comma-sep):',
          g.policies.join(','));
        if (p == null) return;
        await act('POST', '/groups', {name: g.name,
          policies: p.split(',').map(s => s.trim()).filter(Boolean)});
        showGroups();
      }),
      el('span', ' \\u00b7 '),
      el('a', g.status === 'enabled' ? 'disable' : 'enable', async () => {
        await act('POST', '/groups', {name: g.name,
          status: g.status === 'enabled' ? 'disabled' : 'enabled'});
        showGroups();
      }),
      el('span', ' \\u00b7 '),
      el('a', 'remove members', async () => {
        const m = prompt('Members to REMOVE from ' + g.name + ':', g.members.join(','));
        if (m == null) return;
        await act('POST', '/groups', {name: g.name, isRemove: true,
          members: m.split(',').map(s => s.trim()).filter(Boolean)});
        showGroups();
      }),
      el('span', ' \\u00b7 '),
      el('a', 'delete', async () => {
        if (!confirm('Delete group ' + g.name + '? (must be empty)')) return;
        await act('DELETE', '/groups?' + new URLSearchParams({name: g.name}));
        showGroups();
      }));
    body.append(row([g.name, g.status, g.members.join(', ') || '\\u2013',
      g.policies.join(', ') || '\\u2013', actions]));
  }
}
async function showPolicies() {
  $('#crumbs').replaceChildren(el('b', 'policies'));
  $('#actions').replaceChildren();
  const d = await (await api('/policies')).json();
  head(['policy']);
  const body = $('#tbl tbody');
  for (const p of d.policies) body.append(row([p]));
}
async function showObjs(bucket, prefix, marker = '') {
  $('#crumbs').replaceChildren(el('a', 'buckets', showBuckets),
    el('span', ' / '), el('b', bucket), el('span', ' / ' + prefix));
  $('#actions').replaceChildren();
  const q = new URLSearchParams({bucket, prefix, marker, 'max-keys': '100'});
  const d = await (await api('/objects?' + q)).json();
  head(['key', 'size', 'modified']);
  const body = $('#tbl tbody');
  for (const p of d.prefixes)
    body.append(row([el('a', p, () => showObjs(bucket, p)), '\\u2013', '\\u2013']));
  for (const o of d.objects)
    body.append(row([o.name, fmt(o.size),
      new Date(o.modTime * 1000).toISOString().slice(0, 19)]));
  if (!d.prefixes.length && !d.objects.length) body.append(row(['empty', '', '']));
  if (d.truncated)
    body.append(row([el('a', 'next page \\u2192',
      () => showObjs(bucket, prefix, d.nextMarker)), '', '']));
}
if (tok) boot();
</script></body></html>
"""
