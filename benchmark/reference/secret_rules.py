"""A frozen copy of the port's built-in secret rules
(``trivy_tpu_torch/secret/builtin_rules.py``).

Built-in secret detection rules.

Behavioral parity target: the reference's built-in rule inventory
(pkg/fanal/secret/builtin-rules.go — 83 rules) and built-in allow rules
(builtin-allow-rules.go). Same rule IDs, categories, severities, keyword
prefilters and token grammars; patterns authored here in the Python/RE2
common subset (see trivy_tpu_torch/secret/model.py:compile_rx).

Most vendor tokens follow one of two shapes:
  * a self-identifying prefix token (``ghp_…``, ``xoxb-…``) → bare pattern;
  * a context-keyed assignment (``vendor… = "hexchars"``) → built by
    :func:`_assign`.
"""

from __future__ import annotations

from .secret_model import AllowRule, Rule, compile_rx

# Fragments for the context-keyed assignment shape: a vendor word, up to 25
# identifier-ish filler chars, an assignment operator, ≤5 junk chars,
# then the quoted secret charset.
_OPS = r"(=|>|:=|\|\|:|<=|=>|:)"
_FILL = r"[a-z0-9_ .\-,]{0,25}"
_Q = "['\"]"

# Key/value context fragments for the AWS-style (unquoted-capable) shape.
_SP = r"(^|\s+)"
_EP = r"(\s+|$)"
_OQ = "[\"']?"
_ASSIGN = r"\s*(:|=>|=)\s*"


def _assign(vendor: str, secret: str, named: bool = True,
            quote_secret: bool = True) -> str:
    """``(?i)vendor<fill><op>.{0,5}'secret'`` — the common config-file
    assignment context used by most vendor rules."""
    key = f"(?P<key>{vendor}{_FILL})" if named else f"({vendor}{_FILL})"
    sec = f"(?P<secret>{secret})" if named else f"({secret})"
    if quote_secret:
        sec = f"{_Q}{sec}{_Q}"
    return f"(?i){key}{_OPS}.{{0,5}}{sec}"


def _quoted(pattern: str) -> str:
    return f"{_Q}{pattern}{_Q}"


_UUID_UP = "[0-9A-F]{8}-[0-9A-F]{4}-[0-9A-F]{4}-[0-9A-F]{4}-[0-9A-F]{12}"
_UUID_AH = "[a-h0-9]{8}-[a-h0-9]{4}-[a-h0-9]{4}-[a-h0-9]{4}-[a-h0-9]{12}"

# (id, category, title, severity, regex, keywords, secret_group)
# severity None → "" → reported as UNKNOWN (reference: toFinding ternary).
_RULES: list[tuple] = [
    ("aws-access-key-id", "AWS", "AWS Access Key ID", "CRITICAL",
     rf"{_OQ}(?P<secret>(A3T[A-Z0-9]|AKIA|AGPA|AIDA|AROA|AIPA|ANPA|ANVA|ASIA)"
     rf"[A-Z0-9]{{16}}){_OQ}{_EP}",
     ["AKIA", "AGPA", "AIDA", "AROA", "AIPA", "ANPA", "ANVA", "ASIA"],
     "secret"),
    ("aws-secret-access-key", "AWS", "AWS Secret Access Key", "CRITICAL",
     rf"(?i){_SP}{_OQ}(aws)?_?(secret)?_?(access)?_?key{_OQ}{_ASSIGN}{_OQ}"
     rf"(?P<secret>[A-Za-z0-9\/\+=]{{40}}){_OQ}{_EP}",
     ["key"], "secret"),
    ("aws-account-id", "AWS", "AWS Account ID", "HIGH",
     rf"(?i){_SP}{_OQ}(aws)?_?account_?(id)?{_OQ}{_ASSIGN}{_OQ}"
     rf"(?P<secret>[0-9]{{4}}\-?[0-9]{{4}}\-?[0-9]{{4}}){_OQ}{_EP}",
     ["account"], "secret"),
    ("github-pat", "GitHub", "GitHub Personal Access Token", "CRITICAL",
     r"ghp_[0-9a-zA-Z]{36}", ["ghp_"], ""),
    ("github-oauth", "GitHub", "GitHub OAuth Access Token", "CRITICAL",
     r"gho_[0-9a-zA-Z]{36}", ["gho_"], ""),
    ("github-app-token", "GitHub", "GitHub App Token", "CRITICAL",
     r"(ghu|ghs)_[0-9a-zA-Z]{36}", ["ghu_", "ghs_"], ""),
    ("github-refresh-token", "GitHub", "GitHub Refresh Token", "CRITICAL",
     r"ghr_[0-9a-zA-Z]{76}", ["ghr_"], ""),
    ("gitlab-pat", "GitLab", "GitLab Personal Access Token", "CRITICAL",
     r"glpat-[0-9a-zA-Z\-\_]{20}", ["glpat-"], ""),
    ("private-key", "AsymmetricPrivateKey", "Asymmetric Private Key", "HIGH",
     r"(?i)-----\s*?BEGIN[ A-Z0-9_-]*?PRIVATE KEY( BLOCK)?\s*?-----[\s]*?"
     r"(?P<secret>[\sA-Za-z0-9=+/\\\r\n]+)[\s]*?"
     r"-----\s*?END[ A-Z0-9_-]*? PRIVATE KEY( BLOCK)?\s*?-----",
     ["-----"], "secret"),
    ("shopify-token", "Shopify", "Shopify token", "HIGH",
     r"shp(ss|at|ca|pa)_[a-fA-F0-9]{32}",
     ["shpss_", "shpat_", "shpca_", "shppa_"], ""),
    ("slack-access-token", "Slack", "Slack token", "HIGH",
     r"xox[baprs]-([0-9a-zA-Z]{10,48})",
     ["xoxb-", "xoxa-", "xoxp-", "xoxr-", "xoxs-"], ""),
    ("stripe-publishable-token", "Stripe", "Stripe Publishable Key", "LOW",
     r"(?i)pk_(test|live)_[0-9a-z]{10,32}", ["pk_test_", "pk_live_"], ""),
    ("stripe-secret-token", "Stripe", "Stripe Secret Key", "CRITICAL",
     r"(?i)sk_(test|live)_[0-9a-z]{10,32}", ["sk_test_", "sk_live_"], ""),
    ("pypi-upload-token", "PyPI", "PyPI upload token", "HIGH",
     r"pypi-AgEIcHlwaS5vcmc[A-Za-z0-9\-_]{50,1000}",
     ["pypi-AgEIcHlwaS5vcmc"], ""),
    ("gcp-service-account", "Google", "Google (GCP) Service-account",
     "CRITICAL", r"\"type\": \"service_account\"",
     ['"type": "service_account"'], ""),
    ("heroku-api-key", "Heroku", "Heroku API Key", "HIGH",
     " " + _assign("heroku", _UUID_UP), ["heroku"], "secret"),
    ("slack-web-hook", "Slack", "Slack Webhook", "MEDIUM",
     r"https:\/\/hooks.slack.com\/services\/[A-Za-z0-9+\/]{44,48}",
     ["hooks.slack.com"], ""),
    ("twilio-api-key", "Twilio", "Twilio API Key", "MEDIUM",
     r"SK[0-9a-fA-F]{32}", ["SK"], ""),
    ("age-secret-key", "Age", "Age secret key", "MEDIUM",
     r"AGE-SECRET-KEY-1[QPZRY9X8GF2TVDW0S3JN54KHCE6MUA7L]{58}",
     ["AGE-SECRET-KEY-1"], ""),
    ("facebook-token", "Facebook", "Facebook token", "LOW",
     _assign("facebook", "[a-f0-9]{32}"), ["facebook"], "secret"),
    ("twitter-token", "Twitter", "Twitter token", "LOW",
     _assign("twitter", "[a-f0-9]{35,44}"), ["twitter"], "secret"),
    ("adobe-client-id", "Adobe", "Adobe Client ID (Oauth Web)", "LOW",
     _assign("adobe", "[a-f0-9]{32}"), ["adobe"], "secret"),
    ("adobe-client-secret", "Adobe", "Adobe Client Secret", "LOW",
     r"(p8e-)(?i)[a-z0-9]{32}", ["p8e-"], ""),
    ("alibaba-access-key-id", "Alibaba", "Alibaba AccessKey ID", "HIGH",
     r"([^0-9a-z]|^)(?P<secret>(LTAI)(?i)[a-z0-9]{20})([^0-9a-z]|$)",
     ["LTAI"], "secret"),
    ("alibaba-secret-key", "Alibaba", "Alibaba Secret Key", "HIGH",
     _assign("alibaba", "[a-z0-9]{30}"), ["alibaba"], "secret"),
    ("asana-client-id", "Asana", "Asana Client ID", "MEDIUM",
     _assign("asana", "[0-9]{16}"), ["asana"], "secret"),
    ("asana-client-secret", "Asana", "Asana Client Secret", "MEDIUM",
     _assign("asana", "[a-z0-9]{32}"), ["asana"], "secret"),
    ("atlassian-api-token", "Atlassian", "Atlassian API token", "HIGH",
     _assign("atlassian", "[a-z0-9]{24}"), ["atlassian"], "secret"),
    ("bitbucket-client-id", "Bitbucket", "Bitbucket client ID", "HIGH",
     _assign("bitbucket", "[a-z0-9]{32}"), ["bitbucket"], "secret"),
    ("bitbucket-client-secret", "Bitbucket", "Bitbucket client secret",
     "HIGH", _assign("bitbucket", r"[a-z0-9_\-]{64}"), ["bitbucket"],
     "secret"),
    ("beamer-api-token", "Beamer", "Beamer API token", "LOW",
     _assign("beamer", r"b_[a-z0-9=_\-]{44}"), ["beamer"], "secret"),
    ("clojars-api-token", "Clojars", "Clojars API token", "MEDIUM",
     r"(CLOJARS_)(?i)[a-z0-9]{60}", ["CLOJARS_"], ""),
    ("contentful-delivery-api-token", "ContentfulDelivery",
     "Contentful delivery API token", "LOW",
     _assign("contentful", r"[a-z0-9\-=_]{43}"), ["contentful"], "secret"),
    ("databricks-api-token", "Databricks", "Databricks API token", "MEDIUM",
     r"dapi[a-h0-9]{32}", ["dapi"], ""),
    ("discord-api-token", "Discord", "Discord API key", "MEDIUM",
     _assign("discord", "[a-h0-9]{64}"), ["discord"], "secret"),
    ("discord-client-id", "Discord", "Discord client ID", "MEDIUM",
     _assign("discord", "[0-9]{18}"), ["discord"], "secret"),
    ("discord-client-secret", "Discord", "Discord client secret", "MEDIUM",
     _assign("discord", r"[a-z0-9=_\-]{32}"), ["discord"], "secret"),
    ("doppler-api-token", "Doppler", "Doppler API token", "MEDIUM",
     _quoted(r"(dp\.pt\.)(?i)[a-z0-9]{43}"), ["dp.pt."], ""),
    ("dropbox-api-secret", "Dropbox", "Dropbox API secret/key", "HIGH",
     _assign("dropbox", "[a-z0-9]{15}", named=False), ["dropbox"], ""),
    ("dropbox-short-lived-api-token", "Dropbox",
     "Dropbox short lived API token", "HIGH",
     _assign("dropbox", r"sl\.[a-z0-9\-=_]{135}", named=False),
     ["dropbox"], ""),
    ("dropbox-long-lived-api-token", "Dropbox",
     "Dropbox long lived API token", "HIGH",
     f"(?i)(dropbox{_FILL}){_OPS}.{{0,5}}{_Q}"
     r"[a-z0-9]{11}(AAAAAAAAAA)[a-z0-9\-_=]{43}" + _Q,
     ["dropbox"], ""),
    ("duffel-api-token", "Duffel", "Duffel API token", "LOW",
     _quoted(r"duffel_(test|live)_(?i)[a-z0-9_-]{43}"),
     ["duffel_test_", "duffel_live_"], ""),
    ("dynatrace-api-token", "Dynatrace", "Dynatrace API token", "MEDIUM",
     _quoted(r"dt0c01\.(?i)[a-z0-9]{24}\.[a-z0-9]{64}"), ["dt0c01."], ""),
    ("easypost-api-token", "Easypost", "EasyPost API token", "LOW",
     _quoted(r"EZ[AT]K(?i)[a-z0-9]{54}"), ["EZAK", "EZAT"], ""),
    ("fastly-api-token", "Fastly", "Fastly API token", "MEDIUM",
     _assign("fastly", r"[a-z0-9\-=_]{32}"), ["fastly"], "secret"),
    ("finicity-client-secret", "Finicity", "Finicity client secret",
     "MEDIUM", _assign("finicity", "[a-z0-9]{20}"), ["finicity"], "secret"),
    ("finicity-api-token", "Finicity", "Finicity API token", "MEDIUM",
     _assign("finicity", "[a-f0-9]{32}"), ["finicity"], "secret"),
    ("flutterwave-public-key", "Flutterwave", "Flutterwave public/secret key",
     "MEDIUM", r"FLW(PUB|SEC)K_TEST-(?i)[a-h0-9]{32}-X",
     ["FLWSECK_TEST-", "FLWPUBK_TEST-"], ""),
    ("flutterwave-enc-key", "Flutterwave", "Flutterwave encrypted key",
     "MEDIUM", r"FLWSECK_TEST[a-h0-9]{12}", ["FLWSECK_TEST"], ""),
    ("frameio-api-token", "Frameio", "Frame.io API token", "LOW",
     r"fio-u-(?i)[a-z0-9\-_=]{64}", ["fio-u-"], ""),
    ("gocardless-api-token", "GoCardless", "GoCardless API token", "MEDIUM",
     _quoted(r"live_(?i)[a-z0-9\-_=]{40}"), ["live_"], ""),
    ("grafana-api-token", "Grafana", "Grafana API token", "MEDIUM",
     _quoted(r"eyJrIjoi(?i)[a-z0-9\-_=]{72,92}"), ["eyJrIjoi"], ""),
    ("hashicorp-tf-api-token", "HashiCorp",
     "HashiCorp Terraform user/org API token", "MEDIUM",
     _quoted(r"(?i)[a-z0-9]{14}\.atlasv1\.[a-z0-9\-_=]{60,70}"),
     ["atlasv1."], ""),
    ("hubspot-api-token", "HubSpot", "HubSpot API token", "LOW",
     _assign("hubspot", _UUID_AH), ["hubspot"], "secret"),
    ("intercom-api-token", "Intercom", "Intercom API token", "LOW",
     _assign("intercom", "[a-z0-9=_]{60}"), ["intercom"], "secret"),
    ("intercom-client-secret", "Intercom", "Intercom client secret/ID",
     "LOW", _assign("intercom", _UUID_AH), ["intercom"], "secret"),
    ("ionic-api-token", "Ionic", "Ionic API token", None,
     _assign("ionic", "ion_[a-z0-9]{42}", named=False), ["ionic"], ""),
    ("linear-api-token", "Linear", "Linear API token", "MEDIUM",
     r"lin_api_(?i)[a-z0-9]{40}", ["lin_api_"], ""),
    ("linear-client-secret", "Linear", "Linear client secret/ID", "MEDIUM",
     _assign("linear", "[a-f0-9]{32}"), ["linear"], "secret"),
    ("lob-api-key", "Lob", "Lob API Key", "LOW",
     _assign("lob", "(live|test)_[a-f0-9]{35}"), ["lob"], "secret"),
    ("lob-pub-api-key", "Lob", "Lob Publishable API Key", "LOW",
     _assign("lob", "(test|live)_pub_[a-f0-9]{31}"), ["lob"], "secret"),
    ("mailchimp-api-key", "Mailchimp", "Mailchimp API key", "MEDIUM",
     _assign("mailchimp", "[a-f0-9]{32}-us20"), ["mailchimp"], "secret"),
    ("mailgun-token", "Mailgun", "Mailgun private API token", "MEDIUM",
     _assign("mailgun", "(pub)?key-[a-f0-9]{32}"), ["mailgun"], "secret"),
    ("mailgun-signing-key", "Mailgun", "Mailgun webhook signing key",
     "MEDIUM",
     _assign("mailgun", "[a-h0-9]{32}-[a-h0-9]{8}-[a-h0-9]{8}"),
     ["mailgun"], "secret"),
    ("mapbox-api-token", "Mapbox", "Mapbox API token", "MEDIUM",
     r"(?i)(pk\.[a-z0-9]{60}\.[a-z0-9]{22})", ["pk."], ""),
    ("messagebird-api-token", "MessageBird", "MessageBird API token",
     "MEDIUM", _assign("messagebird", "[a-z0-9]{25}"), ["messagebird"],
     "secret"),
    ("messagebird-client-id", "MessageBird", "MessageBird API client ID",
     "MEDIUM", _assign("messagebird", _UUID_AH), ["messagebird"], "secret"),
    ("new-relic-user-api-key", "NewRelic", "New Relic user API Key",
     "MEDIUM", _quoted("(NRAK-[A-Z0-9]{27})"), ["NRAK-"], ""),
    ("new-relic-user-api-id", "NewRelic", "New Relic user API ID", "MEDIUM",
     _assign("newrelic", "[A-Z0-9]{64}"), ["newrelic"], "secret"),
    ("new-relic-browser-api-token", "NewRelic",
     "New Relic ingest browser API token", "MEDIUM",
     _quoted("(NRJS-[a-f0-9]{19})"), ["NRJS-"], ""),
    ("npm-access-token", "Npm", "npm access token", "CRITICAL",
     _quoted("(npm_(?i)[a-z0-9]{36})"), ["npm_"], ""),
    ("planetscale-password", "Planetscale", "PlanetScale password", "MEDIUM",
     r"pscale_pw_(?i)[a-z0-9\-_\.]{43}", ["pscale_pw_"], ""),
    ("planetscale-api-token", "Planetscale", "PlanetScale API token",
     "MEDIUM", r"pscale_tkn_(?i)[a-z0-9\-_\.]{43}", ["pscale_tkn_"], ""),
    ("postman-api-token", "Postman", "Postman API token", "MEDIUM",
     r"PMAK-(?i)[a-f0-9]{24}\-[a-f0-9]{34}", ["PMAK-"], ""),
    ("pulumi-api-token", "Pulumi", "Pulumi API token", "HIGH",
     r"pul-[a-f0-9]{40}", ["pul-"], ""),
    ("rubygems-api-token", "RubyGems", "Rubygem API token", "MEDIUM",
     r"rubygems_[a-f0-9]{48}", ["rubygems_"], ""),
    ("sendgrid-api-token", "SendGrid", "SendGrid API token", "MEDIUM",
     r"SG\.(?i)[a-z0-9_\-\.]{66}", ["SG."], ""),
    ("sendinblue-api-token", "Sendinblue", "Sendinblue API token", "LOW",
     r"xkeysib-[a-f0-9]{64}\-(?i)[a-z0-9]{16}", ["xkeysib-"], ""),
    ("shippo-api-token", "Shippo", "Shippo API token", "LOW",
     r"shippo_(live|test)_[a-f0-9]{40}",
     ["shippo_live_", "shippo_test_"], ""),
    ("linkedin-client-secret", "LinkedIn", "LinkedIn Client secret",
     "MEDIUM", _assign("linkedin", "[a-z]{16}"), ["linkedin"], "secret"),
    ("linkedin-client-id", "LinkedIn", "LinkedIn Client ID", "MEDIUM",
     _assign("linkedin", "[a-z0-9]{14}"), ["linkedin"], "secret"),
    ("twitch-api-token", "Twitch", "Twitch API token", "MEDIUM",
     _assign("twitch", "[a-z0-9]{30}"), ["twitch"], "secret"),
    ("typeform-api-token", "Typeform", "Typeform API token", "LOW",
     _assign("typeform", r"tfp_[a-z0-9\-_\.=]{59}", quote_secret=False),
     ["typeform"], "secret"),
]

BUILTIN_RULES: list[Rule] = [
    Rule(id=rid, category=cat, title=title,
         severity=sev if sev is not None else "",
         regex=compile_rx(rx), keywords=list(kws), secret_group_name=group)
    for rid, cat, title, sev, rx, kws, group in _RULES
]

# Paths excluded from secret scanning out of the box
# (reference: builtin-allow-rules.go:3-64).
_ALLOW_PATHS: list[tuple[str, str, str]] = [
    ("tests", "Avoid test files and paths", r"(\/test|-test|_test|\.test)"),
    ("examples", "Avoid example files and paths", r"example"),
    ("vendor", "Vendor dirs", r"\/vendor\/"),
    ("usr-dirs", "System dirs", r"^usr\/(?:share|include|lib)\/"),
    ("locale-dir", "Locales directory contains locales file",
     r"\/locales?\/"),
    ("markdown", "Markdown files", r"\.md$"),
    ("node.js", "Node container images", r"^opt\/yarn-v[\d.]+\/"),
    ("golang", "Go container images", r"^usr\/local\/go\/"),
    ("python", "Python container images",
     r"^usr\/local\/lib\/python[\d.]+\/"),
    ("rubygems", "Ruby container images", r"^usr\/lib\/gems\/"),
    ("wordpress", "Wordpress container images", r"^usr\/src\/wordpress\/"),
    ("anaconda-log", "Anaconda CI Logs in container images",
     r"^var\/log\/anaconda\/"),
]

BUILTIN_ALLOW_RULES: list[AllowRule] = [
    AllowRule(id=aid, description=desc, path=compile_rx(rx))
    for aid, desc, rx in _ALLOW_PATHS
]
