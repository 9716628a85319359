"""S3 API error codes and XML rendering.

Role of the reference's api-errors.go (cmd/api-errors.go, 2293 lines of error
table): map internal exceptions onto S3 wire error codes. Subset that covers
the implemented API surface; grows with it.
"""

from __future__ import annotations

from dataclasses import dataclass
from xml.sax.saxutils import escape

from ..utils import errors as oerr


@dataclass(frozen=True)
class APIError:
    code: str
    description: str
    http_status: int


ERRORS = {
    "AccessDenied": APIError("AccessDenied", "Access Denied.", 403),
    "BadDigest": APIError("BadDigest", "The Content-Md5 you specified did not match what we received.", 400),
    "BucketAlreadyOwnedByYou": APIError(
        "BucketAlreadyOwnedByYou",
        "Your previous request to create the named bucket succeeded and you already own it.",
        409,
    ),
    "BucketNotEmpty": APIError("BucketNotEmpty", "The bucket you tried to delete is not empty.", 409),
    "EntityTooLarge": APIError("EntityTooLarge", "Your proposed upload exceeds the maximum allowed object size.", 400),
    "EntityTooSmall": APIError("EntityTooSmall", "Your proposed upload is smaller than the minimum allowed object size.", 400),
    "MalformedPOSTRequest": APIError("MalformedPOSTRequest", "The body of your POST request is not well-formed multipart/form-data.", 400),
    "IncompleteBody": APIError("IncompleteBody", "You did not provide the number of bytes specified by the Content-Length HTTP header.", 400),
    "InternalError": APIError("InternalError", "We encountered an internal error, please try again.", 500),
    "InvalidAccessKeyId": APIError("InvalidAccessKeyId", "The Access Key Id you provided does not exist in our records.", 403),
    "InvalidArgument": APIError("InvalidArgument", "Invalid Argument.", 400),
    "InvalidBucketName": APIError("InvalidBucketName", "The specified bucket is not valid.", 400),
    "InvalidBucketState": APIError("InvalidBucketState", "The request is not valid with the current state of the bucket.", 409),
    "InvalidDigest": APIError("InvalidDigest", "The Content-Md5 you specified is not valid.", 400),
    "InvalidPart": APIError("InvalidPart", "One or more of the specified parts could not be found.", 400),
    "InvalidPartOrder": APIError("InvalidPartOrder", "The list of parts was not in ascending order.", 400),
    "InvalidRange": APIError("InvalidRange", "The requested range is not satisfiable.", 416),
    "InvalidPartNumber": APIError("InvalidPartNumber", "The requested partnumber is not satisfiable.", 416),
    "InvalidStorageClass": APIError("InvalidStorageClass", "The storage class you specified is not valid.", 400),
    "MalformedPolicy": APIError("MalformedPolicy", "Policy has an invalid condition.", 400),
    "InvalidRequest": APIError("InvalidRequest", "Invalid Request.", 400),
    "KeyTooLongError": APIError("KeyTooLongError", "Your key is too long.", 400),
    "MalformedXML": APIError("MalformedXML", "The XML you provided was not well-formed or did not validate against our published schema.", 400),
    "MethodNotAllowed": APIError("MethodNotAllowed", "The specified method is not allowed against this resource.", 405),
    "MissingContentLength": APIError("MissingContentLength", "You must provide the Content-Length HTTP header.", 411),
    "NoSuchBucket": APIError("NoSuchBucket", "The specified bucket does not exist.", 404),
    "NoSuchBucketPolicy": APIError("NoSuchBucketPolicy", "The bucket policy does not exist.", 404),
    "NoSuchKey": APIError("NoSuchKey", "The specified key does not exist.", 404),
    "NoSuchUpload": APIError("NoSuchUpload", "The specified multipart upload does not exist.", 404),
    "NoSuchVersion": APIError("NoSuchVersion", "The specified version does not exist.", 404),
    "NoSuchTagSet": APIError("NoSuchTagSet", "The TagSet does not exist.", 404),
    "NoSuchLifecycleConfiguration": APIError("NoSuchLifecycleConfiguration", "The lifecycle configuration does not exist.", 404),
    "ReplicationConfigurationNotFoundError": APIError("ReplicationConfigurationNotFoundError", "The replication configuration was not found.", 404),
    "ServerSideEncryptionConfigurationNotFoundError": APIError("ServerSideEncryptionConfigurationNotFoundError", "The server side encryption configuration was not found.", 404),
    "NoSuchCORSConfiguration": APIError("NoSuchCORSConfiguration", "The CORS configuration does not exist.", 404),
    "NoSuchWebsiteConfiguration": APIError("NoSuchWebsiteConfiguration", "The specified bucket does not have a website configuration.", 404),
    "ObjectLockConfigurationNotFoundError": APIError("ObjectLockConfigurationNotFoundError", "Object Lock configuration does not exist for this bucket.", 404),
    "NoSuchObjectLockConfiguration": APIError("NoSuchObjectLockConfiguration", "The specified object does not have an ObjectLock configuration.", 404),
    "NotImplemented": APIError("NotImplemented", "A header you provided implies functionality that is not implemented.", 501),
    "XMinioAdminBucketQuotaExceeded": APIError("XMinioAdminBucketQuotaExceeded", "Bucket quota exceeded", 400),
    "XMinioAdminUpdateApplyFailure": APIError("XMinioAdminUpdateApplyFailure", "Server update failed", 400),
    "PreconditionFailed": APIError("PreconditionFailed", "At least one of the pre-conditions you specified did not hold.", 412),
    "RequestTimeTooSkewed": APIError("RequestTimeTooSkewed", "The difference between the request time and the server's time is too large.", 403),
    "SignatureDoesNotMatch": APIError("SignatureDoesNotMatch", "The request signature we calculated does not match the signature you provided.", 403),
    "ServiceUnavailable": APIError("ServiceUnavailable", "Please reduce your request rate.", 503),
    "SlowDownRead": APIError("SlowDownRead", "Resource requested is unreadable, please reduce your request rate.", 503),
    "SlowDownWrite": APIError("SlowDownWrite", "Resource requested is unwritable, please reduce your request rate.", 503),
    "XAmzContentSHA256Mismatch": APIError("XAmzContentSHA256Mismatch", "The provided 'x-amz-content-sha256' header does not match what was computed.", 400),
    "AuthorizationHeaderMalformed": APIError("AuthorizationHeaderMalformed", "The authorization header is malformed.", 400),
    "ExpiredPresignRequest": APIError("ExpiredPresignRequest", "Request has expired.", 403),
    "BucketAlreadyExists": APIError("BucketAlreadyExists", "The requested bucket name is not available.", 409),
    "QuorumError": APIError("XMinioStorageQuorum", "Storage resources are insufficient for this operation.", 503),
}


class S3Error(Exception):
    def __init__(self, code: str, message: str | None = None, resource: str = ""):
        self.api = ERRORS.get(code, ERRORS["InternalError"])
        self.code = self.api.code
        self.message = message or self.api.description
        self.resource = resource
        super().__init__(f"{code}: {self.message}")

    def to_xml(self, request_id: str = "") -> str:
        return (
            f"<Error><Code>{escape(self.code)}</Code>"
            f"<Message>{escape(self.message)}</Message>"
            f"<Resource>{escape(self.resource)}</Resource>"
            f"<RequestId>{escape(request_id)}</RequestId>"
            "</Error>"
        )


def from_object_error(e: Exception, bucket: str = "", key: str = "") -> S3Error:
    """Map object-layer exceptions to S3 error codes
    (toAPIErrorCode, cmd/api-errors.go equivalent)."""
    resource = f"/{bucket}/{key}" if key else f"/{bucket}"
    mapping: list[tuple[type, str]] = [
        (oerr.BucketNotFound, "NoSuchBucket"),
        (oerr.BucketExists, "BucketAlreadyOwnedByYou"),
        (oerr.BucketNotEmpty, "BucketNotEmpty"),
        (oerr.BucketNameInvalid, "InvalidBucketName"),
        (oerr.ObjectNotFound, "NoSuchKey"),
        (oerr.VersionNotFound, "NoSuchVersion"),
        (oerr.ObjectNameInvalid, "KeyTooLongError" if len(key) > 1024 else "InvalidArgument"),
        (oerr.MethodNotAllowed, "MethodNotAllowed"),
        (oerr.InvalidUploadID, "NoSuchUpload"),
        (oerr.InvalidPart, "InvalidPart"),
        (oerr.PreconditionFailed, "PreconditionFailed"),
        (oerr.InsufficientReadQuorum, "SlowDownRead"),
        (oerr.InsufficientWriteQuorum, "SlowDownWrite"),
        (oerr.ErasureReadQuorum, "SlowDownRead"),
        (oerr.ErasureWriteQuorum, "SlowDownWrite"),
        # A spent budget means the cluster is slower than the client's
        # patience: answer 503 SlowDown (retryable) rather than 500.
        (oerr.DeadlineExceeded, "SlowDownRead"),
        (oerr.InvalidArgument, "InvalidArgument"),
    ]
    for etype, code in mapping:
        if isinstance(e, etype):
            return S3Error(code, resource=resource)
    return S3Error("InternalError", message=str(e), resource=resource)
